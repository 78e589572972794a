"""Sparse cycle-core elimination (ops/core_elim.py) — MUMPS generality.

The reference's default solver is a sparse direct factorization (MUMPS,
reference ``solver.py:62``) that handles any topology with bounded fill.
These tests pin the array-native equivalent: host-planned minimum-degree
independent-set elimination of unstructured cyclic cores, exact at f64,
on rings, random Delaunay capillary webs (a family the reference's
generators cannot produce), fuzzed coefficients, sweeps and the sharded
path.
"""

import os

import numpy as np
import pytest

import jax

from networks_fenicsx_tpu import (
    HydraulicNetworkAssembler,
    NetworkMesh,
    Solver,
    SolverOptions,
    network_generation,
)
from networks_fenicsx_tpu.solver import _plan_tree_elimination, attach_core_plan


def _two_solutions(mesh, R, f=0.1, p_bc=lambda x: x[0]):
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc, f=f, R=R)
    s = Solver(asm, options=SolverOptions(method="schur"))
    s.assemble()
    s.solve()
    x1 = np.asarray(s.solution_vector())

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc, f=f, R=R)
    s2 = Solver(asm2, options=SolverOptions(method="host_lu"))
    s2.assemble()
    s2.solve()
    x2 = np.asarray(s2.solution_vector())
    return x1, x2, s


def _ring(n):
    import networkx as nx

    G = nx.DiGraph()
    for i in range(n):
        G.add_node(
            i,
            pos=np.array(
                [np.cos(2 * np.pi * i / n), np.sin(2 * np.pi * i / n), 0.0]
            ),
        )
    for i in range(n):
        G.add_edge(i, (i + 1) % n)
    G.add_node(n, pos=np.array([2.0, 0.0, 0.0]))
    G.add_edge(0, n)
    G.add_node(n + 1, pos=np.array([-2.0, 0.0, 0.0]))
    G.add_edge(n // 2, n + 1)
    return G


def test_sparse_core_ring():
    """A pure cycle has no peelable leaves: the whole ring is the core.
    Above the dense threshold the sparse plan must engage and match LU."""
    n = 700
    mesh = NetworkMesh(_ring(n), N=2)
    rng = np.random.default_rng(5)
    R = rng.uniform(0.5, 3.0, mesh.num_edges)

    # the plan engages (independent-set rounds halve a ring: O(log n))
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert tp.core_plan is not None
    stats = tp.core_plan.stats
    assert stats["core"] >= n
    assert stats["rounds"] < 40  # geometric shrink, not O(n) rounds

    x1, x2, _ = _two_solutions(mesh, R)
    err = np.max(np.abs(x1 - x2)) / max(1.0, np.abs(x2).max())
    assert err < 1e-10, err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_core_random_network_fuzz(seed):
    """Fuzzed unstructured capillary webs: irregular junction degrees,
    cycles everywhere, random coefficients — schur == host LU at 1e-10."""
    rng = np.random.default_rng(100 + seed)
    G = network_generation.make_random_network(
        600, keep=float(rng.uniform(0.3, 0.9)), num_boundary=3, seed=seed
    )
    mesh = NetworkMesh(G, N=int(rng.integers(1, 4)), color_strategy="fast")
    R = rng.uniform(0.2, 5.0, mesh.num_edges)
    f = rng.uniform(-1.0, 1.0, mesh.num_edges)
    x1, x2, s = _two_solutions(mesh, R, f=f)
    err = np.max(np.abs(x1 - x2)) / max(1.0, np.abs(x2).max())
    assert err < 1e-10, f"seed {seed}: {err}"


def test_sparse_core_forced_small():
    """Direct unit check: core_eliminate == dense core on a small web
    (dense_cutoff forced tiny so the sparse rounds dominate)."""
    G = network_generation.make_random_network(150, keep=0.6, seed=9)
    mesh = NetworkMesh(G, N=1)
    rng = np.random.default_rng(2)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=0.4, R=R)
    tp = _plan_tree_elimination(asm)
    assert tp.core_size > 0
    tp_sparse = attach_core_plan(tp, dense_cutoff=8)
    assert tp_sparse.core_plan is not None
    assert tp_sparse.core_plan.stats["rounds"] > 0

    x1, x2, _ = _two_solutions(mesh, R, f=0.4, p_bc=lambda x: x[1])
    err = np.max(np.abs(x1 - x2)) / max(1.0, np.abs(x2).max())
    assert err < 1e-10, err


def test_sparse_core_sweep_vmaps():
    """Batched scenario sweeps vmap through the sparse core elimination."""
    from networks_fenicsx_tpu import solve_sweep

    G = network_generation.make_random_network(700, keep=0.55, seed=4)
    mesh = NetworkMesh(G, N=1)
    rng = np.random.default_rng(8)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R0)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    if tp.core_plan is None:
        pytest.skip("core below sparse threshold for this seed")

    scales = np.array([1.0, 1.7, 0.6, 3.2])
    res = solve_sweep(asm, R=R0[None, :] * scales[:, None])
    X = np.asarray(res.x)
    for i, c in enumerate(scales):
        asm_i = HydraulicNetworkAssembler(mesh)
        asm_i.compute_forms(p_bc_ex=lambda x: x[0], R=R0 * c)
        s_i = Solver(asm_i, options=SolverOptions(method="host_lu"))
        s_i.solve()
        ref = np.asarray(s_i.solution_vector())
        err = np.max(np.abs(X[i] - ref)) / max(1.0, np.abs(ref).max())
        assert err < 1e-9, f"scenario {i}: {err}"


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sparse_core_sharded_matches_serial(n_devices):
    """The sharded general pipeline runs the same sparse core elimination
    (replicated after the one w_pairs psum) — sharded == serial."""
    from networks_fenicsx_tpu.parallel import ShardedNetworkSolver

    G = network_generation.make_random_network(650, keep=0.5, seed=11)
    mesh = NetworkMesh(G, N=2)
    rng = np.random.default_rng(3)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=0.2, R=R)
    sh = ShardedNetworkSolver(asm, devices=jax.devices()[:n_devices])
    sh.assemble()
    sol = sh.solve()
    got = np.concatenate([fn.values for fn in sol])

    x1, x2, _ = _two_solutions(mesh, R, f=0.2)
    err = np.max(np.abs(got - x2)) / max(1.0, np.abs(x2).max())
    assert err < 1e-10, err


@pytest.mark.skipif(
    not os.environ.get("NXFX_SLOW_TESTS"), reason="set NXFX_SLOW_TESTS=1"
)
def test_sparse_core_10k_junctions_beats_dense():
    """The VERDICT-scale case: ~10k-junction random cyclic web, exact vs
    SuperLU (the MUMPS stand-in)."""
    import time

    G = network_generation.make_random_network(10_000, keep=0.7, seed=42, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    rng = np.random.default_rng(1)
    R = rng.uniform(0.5, 3.0, mesh.num_edges)
    x1, x2, s = _two_solutions(mesh, R)
    err = np.max(np.abs(x1 - x2)) / max(1.0, np.abs(x2).max())
    assert err < 1e-10, err
    # steady-state re-solve must beat a SuperLU factor+solve
    t0 = time.time()
    s.solve()
    t_schur = time.time() - t0
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    asm = s._assembler
    vals = np.concatenate(
        [np.asarray(asm._cell_mass).ravel(), asm._static_vals]
    )
    A = sp.csc_matrix(
        (vals, (asm._all_rows, asm._all_cols)), shape=(asm.num_dofs,) * 2
    )
    t0 = time.time()
    spla.splu(A).solve(np.asarray(asm._b_host))
    t_lu = time.time() - t0
    assert t_schur < t_lu, (t_schur, t_lu)


def test_tree_factorization_unstructured_web():
    """Factor-reuse serving on an arbitrary topology: TreeFactorization
    (peel rounds + sparse core, conductance side cached) re-solves
    rhs-only and matches the fused solve and host LU; Solver.factorize
    routes it when the blocked/DCT envelopes don't apply."""
    from networks_fenicsx_tpu.solver import build_tree_factorization

    G = network_generation.make_random_network(700, keep=0.55, seed=21)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    rng = np.random.default_rng(9)
    E = mesh.num_edges
    R = rng.uniform(0.5, 3.0, E)
    asm = HydraulicNetworkAssembler(mesh)
    f0 = rng.uniform(-1.0, 1.0, E)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=f0, R=R)

    fac = build_tree_factorization(asm)
    state = fac.factor(R)
    args = asm.schur_arguments(device=False)
    out = fac.solve(state, args[1], args[2], args[3])
    x = fac.solution_vector(out)

    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    scale = max(1.0, np.abs(refv).max())
    np.testing.assert_allclose(x, refv, atol=1e-10 * scale)

    # rhs-only re-solve against the same factor (new f and p_bc)
    f1 = rng.uniform(-1.0, 1.0, E)
    asm.compute_forms(p_bc_ex=lambda x: 3.0 * x[1], f=f1, R=R)
    args1 = asm.schur_arguments(device=False)
    out1 = fac.solve(state, args1[1], args1[2], args1[3])
    x1 = fac.solution_vector(out1)
    ref1 = Solver(asm, options=SolverOptions(method="host_lu"))
    ref1.solve()
    ref1v = np.asarray(ref1.solution_vector())
    np.testing.assert_allclose(
        x1, ref1v, atol=1e-10 * max(1.0, np.abs(ref1v).max())
    )

    # batched rhs sweep against one factor
    S = 3
    fb = rng.uniform(-1.0, 1.0, (S, E))
    spb = np.broadcast_to(args1[2], (S, E)).copy()
    epb = np.broadcast_to(args1[3], (S, E)).copy()
    outb = fac.solve_batch(state, fb, spb, epb)
    for i in range(S):
        asm.compute_forms(p_bc_ex=lambda x: 3.0 * x[1], f=fb[i], R=R)
        ref_i = Solver(asm, options=SolverOptions(method="host_lu"))
        ref_i.solve()
        ref_iv = np.asarray(ref_i.solution_vector())
        got_i = fac.solution_vector([o[i] for o in outb])
        np.testing.assert_allclose(
            got_i, ref_iv, atol=1e-10 * max(1.0, np.abs(ref_iv).max())
        )

    # Solver.factorize routes the tree factorization for this topology
    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=lambda x: x[0], f=f0, R=R)
    s2 = Solver(asm2)
    s2.factorize()
    asm2.compute_forms(p_bc_ex=lambda x: x[0] - x[1], f=f1, R=R)
    s2.solve()
    assert s2.info.method == "schur_factorized"
    ref2 = Solver(asm2, options=SolverOptions(method="host_lu"))
    ref2.solve()
    ref2v = np.asarray(ref2.solution_vector())
    got2 = np.asarray(s2.solution_vector())
    np.testing.assert_allclose(
        got2, ref2v, atol=1e-10 * max(1.0, np.abs(ref2v).max())
    )


def test_nested_dissection_order_forced_small():
    """The ND-ordered local-min planner variant is exact: force it on a
    lattice core where min-degree also works and pin vs host LU."""
    from networks_fenicsx_tpu.solver import _schur_solve, build_schur_executor
    from networks_fenicsx_tpu.ops.core_elim import (
        nested_dissection_order,
        plan_core_elimination,
    )

    G = network_generation.make_grid(40, 40, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(6)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    plan = _plan_tree_elimination(asm)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=8)
    assert np.array_equal(np.sort(nd), np.arange(plan.core_size))
    cp = plan_core_elimination(
        pairs, plan.core_size, dense_cutoff=64, kcap=64, order=nd,
        tail_stop=False,
    )
    assert cp is not None and cp.stats["rounds"] > 0, cp and cp.stats
    forced = plan._replace(core_plan=cp)

    opts = SolverOptions(method="schur", schur_method="tree")
    ex = build_schur_executor(asm, opts, _tree_plan=forced)
    x, info = _schur_solve(asm, opts, executor=ex)
    assert info.converged
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(x) - rv)) / max(1.0, np.abs(rv).max())
    assert err < 1e-10, err


@pytest.mark.skipif(
    not os.environ.get("NXFX_SLOW_TESTS"), reason="set NXFX_SLOW_TESTS=1"
)
def test_nested_dissection_fallback_large_lattice():
    """Per-edge-R lattices beyond min-degree's fill budget (>= 192 per
    side) auto-engage the ND-ordered plan and stay exact vs host LU —
    the last MUMPS-generality cell (min-degree alone planned only to
    ~128²)."""
    n = 192
    G = network_generation.make_grid(n, n, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(n)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert tp.core_plan is not None, "ND fallback did not engage"
    assert tp.core_plan.stats["rounds"] > 0
    s = Solver(asm)
    s.solve()
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(s.solution_vector()) - rv))
    assert err < 1e-9 * max(1.0, np.abs(rv).max()), err


def test_supernodal_front_tail_forced():
    """Multifrontal supernodal tail (the >8k-separator-tail path for
    512²+ per-edge-R lattices): force tiny fronts on a 40² lattice so
    several fronts chain through extend-add consumption, and pin the
    solution vs host LU."""
    from networks_fenicsx_tpu.solver import _schur_solve, build_schur_executor
    from networks_fenicsx_tpu.ops.core_elim import (
        nested_dissection_order,
        plan_core_elimination,
    )

    G = network_generation.make_grid(40, 40, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(7)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    plan = _plan_tree_elimination(asm)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=8)
    cp = plan_core_elimination(
        pairs, plan.core_size, dense_cutoff=64, kcap=24, order=nd,
        dense_cap=16, supernodal_tail=True, front_max=37, tail_stop=False,
    )
    assert cp is not None, "front planner gave up"
    assert len(cp.fronts) > 2, cp.stats
    assert cp.stats["dense_tail"] == 0
    # at least one front consumes an earlier front's update matrix
    assert any(f.consume for f in cp.fronts)
    forced = plan._replace(core_plan=cp)
    opts = SolverOptions(method="schur", schur_method="tree")
    ex = build_schur_executor(asm, opts, _tree_plan=forced)
    x, info = _schur_solve(asm, opts, executor=ex)
    assert info.converged
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(x) - rv)) / max(1.0, np.abs(rv).max())
    assert err < 1e-10, err


def test_supernodal_front_cap_refuses():
    """A front outgrowing front_cap makes the planner return None (the
    caller keeps the dense/CG fallback) rather than building an
    over-sized dense front."""
    from networks_fenicsx_tpu.ops.core_elim import (
        nested_dissection_order,
        plan_core_elimination,
    )

    G = network_generation.make_grid(24, 24, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=1.0)
    plan = _plan_tree_elimination(asm)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=8)
    cp = plan_core_elimination(
        pairs, plan.core_size, dense_cutoff=32, kcap=8, order=nd,
        dense_cap=8, supernodal_tail=True, front_max=16, front_cap=24,
        tail_stop=False,
    )
    assert cp is None


@pytest.mark.skipif(
    not os.environ.get("NXFX_SLOW_TESTS"), reason="set NXFX_SLOW_TESTS=1"
)
def test_supernodal_front_tail_large_lattice():
    """320² per-edge-R lattice: beyond the single-dense-tail envelope
    (stalled separator tail ≈ 9.7k > 8192), the auto path now engages
    supernodal fronts and stays exact vs host LU."""
    n = 320
    G = network_generation.make_grid(n, n, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(n)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert tp.core_plan is not None, "ND+fronts did not engage"
    assert len(tp.core_plan.fronts) > 0, tp.core_plan.stats
    s = Solver(asm)
    s.solve()
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(s.solution_vector()) - rv))
    assert err < 1e-9 * max(1.0, np.abs(rv).max()), err


@pytest.mark.skipif(
    not os.environ.get("NXFX_XL_TESTS"), reason="set NXFX_XL_TESTS=1 (~5 min)"
)
def test_supernodal_front_tail_512_lattice():
    """512² per-edge-R lattice (262k core): the full benchmark-family
    size solves exact direct through ND rounds + supernodal fronts.
    Measured on CPU: plan ~80 s (68 rounds, 26 fronts <= 2533 wide,
    fill 3.6M), rel err 1.7e-11 vs host LU (host LU itself 33 s)."""
    n = 512
    G = network_generation.make_grid(n, n, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(n)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert tp.core_plan is not None, "ND+fronts did not engage"
    assert len(tp.core_plan.fronts) > 0, tp.core_plan.stats
    assert tp.core_plan.stats["dense_tail"] == 0, tp.core_plan.stats
    s = Solver(asm)
    s.solve()
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(s.solution_vector()) - rv))
    assert err < 1e-9 * max(1.0, np.abs(rv).max()), err


@pytest.mark.skipif(
    not os.environ.get("NXFX_SLOW_TESTS"), reason="set NXFX_SLOW_TESTS=1"
)
def test_supernodal_front_tail_vmaps():
    """Scenario sweeps vmap through the multifrontal tail: the per-front
    Cholesky/extend-add chain must batch (large per-edge-R lattice sweeps
    route here).  Forced tiny fronts on a 40² lattice, 3 R scalings vs
    per-scenario host LU."""
    from networks_fenicsx_tpu.solver import build_schur_executor
    from networks_fenicsx_tpu.ops.core_elim import (
        nested_dissection_order,
        plan_core_elimination,
    )

    G = network_generation.make_grid(26, 26, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(17)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R0)
    plan = _plan_tree_elimination(asm)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=8)
    cp = plan_core_elimination(
        pairs, plan.core_size, dense_cutoff=64, kcap=24, order=nd,
        dense_cap=16, supernodal_tail=True, front_max=23, tail_stop=False,
    )
    assert cp is not None and cp.fronts
    forced = plan._replace(core_plan=cp)
    opts = SolverOptions(method="schur", schur_method="tree")
    ex = build_schur_executor(
        asm, opts, jit=False, _tree_plan=forced,
        outputs="blocks", internal_layout=True,
    )
    import jax.numpy as jnp

    prepare = getattr(ex, "prepare_args", None)
    base_R, base_f, base_sp, base_ep = asm.schur_arguments(
        device=prepare is None
    )
    if prepare is not None:
        base_R, base_f, base_sp, base_ep = prepare(
            base_R, base_f, base_sp, base_ep
        )
    scales = np.array([1.0, 1.9])
    RB = jnp.asarray(base_R)[None] * scales[:, None]

    def one(Ra):
        q_T, p_T, lam, *_ = ex(Ra, base_f, base_sp, base_ep)
        return lam

    lams = np.asarray(jax.jit(jax.vmap(one))(RB))
    # vmapped batch must equal the serial loop of the same executor
    for i, c in enumerate(scales):
        ref = np.asarray(one(jnp.asarray(base_R) * c))
        err = np.max(np.abs(lams[i] - ref)) / max(1.0, np.abs(ref).max())
        assert err < 1e-12, f"scenario {i}: {err}"


@pytest.mark.skipif(
    not os.environ.get("NXFX_XL_TESTS"), reason="set NXFX_XL_TESTS=1 (~4 min)"
)
def test_supernodal_front_tail_50k_web():
    """50k-junction irregular Delaunay web (120k vessels): min-degree
    blows its fill budget, ND + supernodal fronts engage (measured: 54
    rounds, 10 fronts <= 2974 wide, no dense tail) and the solve is
    exact vs host LU (4.6e-13 measured)."""
    G = network_generation.make_random_network(50_000, seed=42)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(1)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    tp = attach_core_plan(_plan_tree_elimination(asm))
    assert tp.core_plan is not None, "ND+fronts did not engage"
    assert len(tp.core_plan.fronts) > 0, tp.core_plan.stats
    s = Solver(asm)
    s.solve()
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    rv = np.asarray(ref.solution_vector())
    err = np.max(np.abs(np.asarray(s.solution_vector()) - rv))
    assert err < 1e-9 * max(1.0, np.abs(rv).max()), err


def test_tree_factorization_supernodal_fronts():
    """Factor-reuse serving through the multifrontal tail: a forced
    fronts plan (the 512²+ lattice path) must round-trip factor() /
    rhs-only solve() exactly — per-front Cholesky state is part of the
    cached factor."""
    from networks_fenicsx_tpu.solver import (
        _plan_tree_elimination as _pte,
        build_tree_factorization,
    )
    from networks_fenicsx_tpu.ops.core_elim import (
        nested_dissection_order,
        plan_core_elimination,
    )

    G = network_generation.make_grid(26, 26, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    rng = np.random.default_rng(31)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
    plan = _pte(asm, force_rounds=True)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=8)
    cp = plan_core_elimination(
        pairs, plan.core_size, dense_cutoff=64, kcap=24, order=nd,
        dense_cap=16, supernodal_tail=True, front_max=23, tail_stop=False,
    )
    assert cp is not None and cp.fronts
    fac = build_tree_factorization(asm, _tree_plan=plan._replace(core_plan=cp))
    state = fac.factor(R)
    args = asm.schur_arguments(device=False)
    out = fac.solve(state, args[1], args[2], args[3])
    x = fac.solution_vector(out)
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    np.testing.assert_allclose(x, refv, atol=1e-10 * max(1.0, np.abs(refv).max()))

    # rhs-only re-solve (new p_bc) against the same cached factor
    asm.compute_forms(p_bc_ex=lambda x: 2.0 * x[1] - x[0], R=R)
    args1 = asm.schur_arguments(device=False)
    out1 = fac.solve(state, args1[1], args1[2], args1[3])
    x1 = fac.solution_vector(out1)
    ref1 = Solver(asm, options=SolverOptions(method="host_lu"))
    ref1.solve()
    ref1v = np.asarray(ref1.solution_vector())
    np.testing.assert_allclose(
        x1, ref1v, atol=1e-10 * max(1.0, np.abs(ref1v).max())
    )
