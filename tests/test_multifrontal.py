"""Tree-multifrontal core engine (ops/multifrontal.py).

The batched-front replacement for the rounds-based sparse elimination on
large cores (MUMPS' multifrontal structure, reference ``solver.py:62``):
f32 batched panel Cholesky + one-hot-matmul assembly, f64 iterative
refinement.  Pinned here: the custom batched dense kernel, planner
structure, exactness vs host LU through the public solver path (the
auto-routing), vmap-ability, factor reuse, and planner refusal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from networks_fenicsx_tpu import (
    HydraulicNetworkAssembler,
    NetworkMesh,
    Solver,
    SolverOptions,
    network_generation,
)
from networks_fenicsx_tpu.ops.multifrontal import (
    MFPlan,
    _mf_apply,
    _mf_factor,
    build_nd_tree,
    chol_inverse_batched,
    plan_multifrontal,
)
from networks_fenicsx_tpu.solver import _plan_tree_elimination, attach_core_plan


def _lattice_core(n):
    idx = np.arange(n * n).reshape(n, n)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    pairs = np.concatenate([h, v], axis=0)
    P = pairs.shape[0]
    return (
        np.concatenate([pairs, np.arange(P, dtype=np.int64)[:, None]], axis=1),
        n * n,
    )


def _spd_core(core_pairs, n_core, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, core_pairs.shape[0])
    dc = np.zeros(n_core)
    np.add.at(dc, core_pairs[:, 0], w)
    np.add.at(dc, core_pairs[:, 1], w)
    return dc * 1.001 + 0.05, w, rng.standard_normal(n_core)


def _scipy_solve(core_pairs, n_core, dc, w, rc):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = sp.csc_matrix(
        (np.concatenate([dc, -w, -w]),
         (np.concatenate([np.arange(n_core), core_pairs[:, 0], core_pairs[:, 1]]),
          np.concatenate([np.arange(n_core), core_pairs[:, 1], core_pairs[:, 0]]))),
        shape=(n_core, n_core),
    )
    return spla.splu(A).solve(rc)


@pytest.mark.parametrize("k,w", [(7, 5), (3, 33), (1, 70)])
def test_chol_inverse_batched(k, w):
    """The batched front inverse must reproduce inv(chol(A)) at f32
    accuracy."""
    rng = np.random.default_rng(k * 100 + w)
    M = rng.standard_normal((k, w, w))
    A = (M @ np.swapaxes(M, 1, 2) + w * np.eye(w)).astype(np.float32)
    Li = np.asarray(jax.jit(chol_inverse_batched)(jnp.asarray(A)))
    for i in range(k):
        ref = np.linalg.inv(np.linalg.cholesky(A[i].astype(np.float64)))
        assert np.allclose(Li[i], ref, rtol=2e-4, atol=2e-4), (i, np.abs(Li[i] - ref).max())
        # strictly lower triangular (incl. the zero upper half)
        assert np.allclose(np.triu(Li[i], 1), 0.0)


def test_nd_tree_postorder_invariants():
    cp, nc = _lattice_core(12)
    pivots, children = build_nd_tree(cp, nc, leaf=8)
    seen = np.zeros(nc, dtype=bool)
    for f, piv in enumerate(pivots):
        for c in children[f]:
            assert c < f  # postorder: children precede parents
        assert not seen[piv].any()
        seen[piv] = True
    assert seen.all()  # a partition of the core


@pytest.mark.parametrize("n,leaf", [(9, 4), (24, 16), (40, 64)])
def test_mf_exact_vs_scipy(n, leaf):
    cp, nc = _lattice_core(n)
    plan = plan_multifrontal(cp, nc, leaf=leaf)
    assert plan is not None
    dc, w, rc = _spd_core(cp, nc, seed=n)
    state = jax.jit(_mf_factor)(plan, jnp.asarray(dc), jnp.asarray(w))
    lam = np.asarray(jax.jit(_mf_apply)(plan, state, jnp.asarray(rc)))
    ref = _scipy_solve(cp, nc, dc, w, rc)
    err = np.max(np.abs(lam - ref)) / np.max(np.abs(ref))
    assert err < 1e-11, err


def test_mf_refusal_on_tight_budget():
    """front_cap violations refuse (None): callers keep the rounds path."""
    cp, nc = _lattice_core(24)
    assert plan_multifrontal(cp, nc, leaf=8, front_cap=12) is None
    assert plan_multifrontal(cp, nc, leaf=8, max_groups=2) is None


def test_mf_engages_on_public_path_lattice():
    """Auto-routing: a >2048-node per-edge-R lattice core plans through
    the multifrontal engine and matches host LU at 1e-10."""
    n = 52
    G = network_generation.make_grid(n, n, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(7)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert isinstance(tp.core_plan, MFPlan), (
        None if tp.core_plan is None else tp.core_plan.stats
    )
    s = Solver(asm)
    s.solve()
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(s.solution_vector()) - rv))
    assert err < 1e-10 * max(1.0, np.abs(rv).max()), err


def test_mf_engages_on_public_path_web():
    """Unstructured Delaunay web (the VERDICT r4 'try ND on webs' item):
    the multifrontal engine must handle irregular separators and match
    host LU."""
    G = network_generation.make_random_network(2600, keep=0.7, seed=3,
                                               arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(1)
    R = rng.uniform(0.5, 3.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert isinstance(tp.core_plan, MFPlan), (
        None if tp.core_plan is None else tp.core_plan.stats
    )
    s = Solver(asm)
    s.solve()
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(s.solution_vector()) - rv))
    assert err < 1e-10 * max(1.0, np.abs(rv).max()), err


def test_mf_vmaps():
    """The engine must vmap over coefficient sweeps (the serving batch
    contract shared by all core paths)."""
    cp, nc = _lattice_core(16)
    plan = plan_multifrontal(cp, nc, leaf=16)
    assert plan is not None
    dc, w, rc = _spd_core(cp, nc, seed=2)
    scales = np.asarray([0.5, 1.0, 2.0])

    def one(s):
        st = _mf_factor(plan, jnp.asarray(dc) * s, jnp.asarray(w) * s)
        return _mf_apply(plan, st, jnp.asarray(rc))

    batched = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(scales)))
    for i, s in enumerate(scales):
        ref = _scipy_solve(cp, nc, dc * s, w * s, rc)
        err = np.max(np.abs(batched[i] - ref)) / np.max(np.abs(ref))
        assert err < 1e-11, (i, err)


def test_mf_factor_reuse_matches_fused():
    """TreeFactorization factor-reuse through the MF core == fused solve."""
    from networks_fenicsx_tpu.solver import build_tree_factorization

    n = 52
    G = network_generation.make_grid(n, n, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(11)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    s = Solver(asm)
    s.solve()
    x_fused = np.asarray(s.solution_vector())

    fac = build_tree_factorization(asm, SolverOptions())
    R_a, f_a, sp_a, ep_a = asm.schur_arguments(device=False)
    state = fac.factor(R_a)
    out = fac.solve_prepared(state, fac.prepare_rhs(f_a, sp_a, ep_a))
    from networks_fenicsx_tpu.solver import _flatten_blocks_host

    x_fac = _flatten_blocks_host(
        out[0], out[1], out[2], mesh.edge_color,
        edge_order=getattr(fac, "edge_order", None),
        bif_order=getattr(fac, "bif_order", None),
    )
    err = np.max(np.abs(x_fac - x_fused)) / max(1.0, np.abs(x_fused).max())
    assert err < 1e-9, err
