"""Solver verification: analytic solutions, cross-method agreement, and
conservation laws.

The reference never asserts on solver output (SURVEY §4 "What is NOT
tested"); this suite goes further, checking against exact closed-form
solutions and requiring all solve methods (schur condensation, dense,
MINRES, host sparse LU) to agree to tight tolerances.
"""

import networkx as nx
import numpy as np
import pytest

from networks_fenicsx_tpu import (
    HydraulicNetworkAssembler,
    NetworkMesh,
    Solver,
    SolverOptions,
    network_generation,
)


def p_bc_y(x):
    return x[1]


def _solve(mesh, method, flux_degree=1, pressure_degree=0, f=None, R=None, **kw):
    asm = HydraulicNetworkAssembler(mesh, flux_degree, pressure_degree)
    asm.compute_forms(p_bc_ex=kw.pop("p_bc", p_bc_y), f=f, R=R)
    solver = Solver(asm, options=SolverOptions(method=method, **kw))
    solver.assemble()
    return asm, solver, solver.solve()


def _analytic_y_lambda():
    """Hand-derived Y-bifurcation solution for make_tree(2, 1, 3), p_bc=y.

    Edge lengths: root 0.5, branches sqrt(2.5).  λ at the junction solves
    −2λ = 2(λ+1)/sqrt(2.5)  →  λ = −1/(sqrt(2.5)+1).
    """
    s = np.sqrt(2.5)
    lam = -1.0 / (s + 1.0)
    q_root = 2.0 / (s + 1.0)
    q_branch = 1.0 / (s + 1.0)
    return lam, q_root, q_branch


@pytest.mark.parametrize("method", ["schur", "dense", "minres", "host_lu"])
@pytest.mark.parametrize("N", [1, 4])
def test_y_bifurcation_analytic(method: str, N: int):
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=N)
    asm, solver, sol = _solve(mesh, method, rtol=1e-13)
    lam, q_root, q_branch = _analytic_y_lambda()

    lm_vals = sol[-1].values
    np.testing.assert_allclose(lm_vals, [lam], atol=1e-9)

    # Flux on the root edge (edge 0) is constant q_root; branches q_branch.
    flux_by_edge = {}
    for fn in sol[:-2]:
        view = mesh.submeshes[fn.space.color]
        per_edge = fn.values.reshape(view.edge_ids.size, -1)
        for i, e in enumerate(view.edge_ids):
            flux_by_edge[int(e)] = per_edge[i]
    np.testing.assert_allclose(flux_by_edge[0], q_root, atol=1e-9)
    np.testing.assert_allclose(flux_by_edge[1], q_branch, atol=1e-9)
    np.testing.assert_allclose(flux_by_edge[2], q_branch, atol=1e-9)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("coloring", [None, "largest_first", "fast"])
def test_cross_method_agreement(n: int, coloring):
    """schur (structure-exploiting) == dense == host_lu on trees."""
    G = network_generation.make_tree(n, 1.0, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy=coloring)
    _, _, sol_schur = _solve(mesh, "schur")
    _, _, sol_dense = _solve(mesh, "dense")
    _, _, sol_lu = _solve(mesh, "host_lu")
    for fs, fd, fl in zip(sol_schur, sol_dense, sol_lu):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-9)
        np.testing.assert_allclose(fs.values, fl.values, atol=1e-9)


def test_minres_agreement():
    G = network_generation.make_tree(3, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2)
    _, _, sol_schur = _solve(mesh, "schur")
    _, _, sol_minres = _solve(mesh, "minres", rtol=1e-13)
    for fs, fm in zip(sol_schur, sol_minres):
        np.testing.assert_allclose(fs.values, fm.values, atol=1e-7)


@pytest.mark.parametrize("k", [2, 3])
def test_higher_flux_degree(k: int):
    """Static condensation path (k > 1) must match the dense solve."""
    G = network_generation.make_tree(3, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2)
    _, _, sol_schur = _solve(mesh, "schur", flux_degree=k)
    _, _, sol_dense = _solve(mesh, "dense", flux_degree=k)
    for fs, fd in zip(sol_schur, sol_dense):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-8)


def test_source_term():
    """With f nonzero, continuity forces dq/ds = f; schur == dense."""
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=4)
    f_const = 2.5
    _, _, s1 = _solve(mesh, "schur", f=f_const)
    _, _, s2 = _solve(mesh, "dense", f=f_const)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.values, b.values, atol=1e-9)
    # check dq/ds = f on the root edge: q at chain nodes rises by f*h
    flux0 = next(fn for fn in s1[:-2] if 0 in mesh.submeshes[fn.space.color].edge_ids)
    view = mesh.submeshes[flux0.space.color]
    row = list(view.edge_ids).index(0)
    q = flux0.values.reshape(view.edge_ids.size, -1)[row]
    h = mesh.edge_length[0] / mesh.N
    np.testing.assert_allclose(np.diff(q), f_const * h, atol=1e-9)


def test_variable_resistance():
    """Per-edge R (radius-dependent conductance): schur == dense, and the
    fluxes follow the analytic conductance ratio on a Y."""
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=3)
    R_edges = np.array([1.0, 2.0, 4.0])
    _, _, s1 = _solve(mesh, "schur", R=R_edges)
    _, _, s2 = _solve(mesh, "dense", R=R_edges)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.values, b.values, atol=1e-9)
    # analytic: W_e = R_e * L_e; conservation at the single junction
    L = mesh.edge_length
    W = R_edges * L
    # q_root = (0 - λ)/W0; q_i = (λ + 1)/W_i ; q_root = q_1 + q_2
    lam = -(1 / W[1] + 1 / W[2]) / (1 / W[0] + 1 / W[1] + 1 / W[2])
    np.testing.assert_allclose(s1[-1].values, [lam], atol=1e-10)


def test_callable_resistance():
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=3)

    def R(x):
        return 1.0 + 0.5 * x[1] ** 2

    _, _, s1 = _solve(mesh, "schur", R=R)
    _, _, s2 = _solve(mesh, "dense", R=R)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.values, b.values, atol=1e-9)


def test_conservation_at_bifurcations():
    """Mass conservation Σ q_in = Σ q_out at every junction of a deep tree."""
    G = network_generation.make_tree(5, 2.0, 3.0)
    mesh = NetworkMesh(G, N=2, color_strategy="smallest_last")
    asm, solver, sol = _solve(mesh, "schur")
    flux_end = {}
    flux_start = {}
    for fn in sol[:-2]:
        view = mesh.submeshes[fn.space.color]
        per_edge = fn.values.reshape(view.edge_ids.size, -1)
        for i, e in enumerate(view.edge_ids):
            flux_start[int(e)] = per_edge[i, 0]
            flux_end[int(e)] = per_edge[i, -1]
    for b_idx in range(len(mesh.bifurcation_values)):
        qin = sum(flux_end[int(e)] for e in mesh.in_edge_ids(b_idx))
        qout = sum(flux_start[int(e)] for e in mesh.out_edge_ids(b_idx))
        assert abs(qin - qout) < 1e-10


def test_arterial_tree_solves():
    G = network_generation.make_arterial_tree(N=4, direction=np.array([0.1, 1, 0]))
    mesh = NetworkMesh(G, N=5, color_strategy="largest_first")
    assert mesh.edge_radius is not None
    # radius-dependent Poiseuille resistance R ∝ 1/r^4
    R = 1.0 / mesh.edge_radius**4
    _, solver, sol = _solve(mesh, "schur", R=R)
    assert solver.info.converged
    _, _, sol_d = _solve(mesh, "dense", R=R)
    for a, b in zip(sol, sol_d):
        np.testing.assert_allclose(a.values, b.values, atol=1e-8)


def test_cyclic_core_elimination():
    """Peel-then-core: a network whose bifurcation graph has cycles is
    peeled down to the cycle core, which solves densely — results match
    host sparse LU."""
    G = nx.DiGraph()
    pos = {
        0: (0, 0, 0), 1: (0, 0, 1), 2: (0.2, 0.2, 2), 3: (-0.2, 0.3, 2),
        4: (0, 0.1, 2.1), 5: (0.1, -0.1, 3), 6: (-0.3, 0.4, 4), 7: (0, 0, 1.1),
    }
    for k, v in pos.items():
        G.add_node(k, pos=np.array(v, dtype=float))
    for e in [(0, 1), (1, 7), (7, 2), (2, 5), (7, 3), (3, 4), (4, 5), (7, 4), (5, 6)]:
        G.add_edge(*e)
    mesh = NetworkMesh(G, N=3)
    from networks_fenicsx_tpu.solver import _plan_tree_elimination

    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[2])
    plan = _plan_tree_elimination(asm)
    assert plan.core_size > 0  # genuinely cyclic

    _, s_tree, sol_tree = _solve(mesh, "schur", schur_method="tree", p_bc=lambda x: x[2])
    assert s_tree.info.converged
    _, _, sol_lu = _solve(mesh, "host_lu", p_bc=lambda x: x[2])
    for a, b in zip(sol_tree, sol_lu):
        np.testing.assert_allclose(a.values, b.values, atol=1e-9)


def test_schur_cg_variant():
    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=1)
    _, _, s_dense = _solve(mesh, "schur", schur_method="dense")
    _, _, s_cg = _solve(mesh, "schur", schur_method="cg", rtol=1e-14)
    for a, b in zip(s_dense, s_cg):
        np.testing.assert_allclose(a.values, b.values, atol=1e-8)


def test_continuous_pressure_solves():
    """pressure_degree >= 1 (continuous) goes through the generic path.

    Note the stable pairing is flux degree k+1 with continuous pressure
    degree k; equal-order (1, 1) is inf-sup unstable (singular), verified in
    test_equal_order_pressure_singular below."""
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=2)
    asm = HydraulicNetworkAssembler(mesh, flux_degree=2, pressure_degree=1)
    asm.compute_forms(p_bc_ex=p_bc_y)
    solver = Solver(asm, options=SolverOptions(method="dense"))
    solver.assemble()
    sol = solver.solve()
    assert solver.info.converged
    # fluxes remain conserved at the junction
    flux_by_edge = {}
    for fn in sol[:-2]:
        view = mesh.submeshes[fn.space.color]
        per_edge = fn.values.reshape(view.edge_ids.size, -1)
        for i, e in enumerate(view.edge_ids):
            flux_by_edge[int(e)] = per_edge[i]
    qin = flux_by_edge[0][-1]
    qout = flux_by_edge[1][0] + flux_by_edge[2][0]
    assert abs(qin - qout) < 1e-9


@pytest.mark.parametrize("k,kp", [(2, 1), (3, 2)])
def test_continuous_pressure_reduced_solver(k, kp):
    """schur_p: per-edge flux elimination + CG on the SPD (p, λ) system ==
    dense solve, for stable Pk/P(k-1) pairings."""
    G = network_generation.make_tree(3, 1, 2)
    mesh = NetworkMesh(G, N=3)

    def _go(method):
        asm = HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        asm.compute_forms(p_bc_ex=p_bc_y)
        s = Solver(asm, options=SolverOptions(method=method, rtol=1e-13))
        s.assemble()
        return s, s.solve()

    s1, sol1 = _go("schur_p")
    assert s1.info.converged and s1.info.method == "schur_p"
    _, sol2 = _go("dense")
    for a, b in zip(sol1, sol2):
        np.testing.assert_allclose(a.values, b.values, atol=1e-10)


def test_equal_order_pressure_singular():
    """Equal-order continuous pressure (k=1, kp=1) is inf-sup unstable; the
    assembled matrix is rank deficient."""
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=2)
    asm = HydraulicNetworkAssembler(mesh, flux_degree=1, pressure_degree=1)
    asm.compute_forms(p_bc_ex=p_bc_y)
    A, _ = asm.assemble(kind="dense")
    A = np.asarray(A)
    assert np.linalg.matrix_rank(A, tol=1e-10) < A.shape[0]


def test_not_converged_raises():
    """A floating network component (no boundary) is singular; the solver
    must fail loudly (the PETSc analog: ksp_error_if_not_converged,
    reference solver.py:64)."""
    G = nx.DiGraph()
    # triangle cycle with no boundary nodes
    for i, pos in enumerate([(0, 0), (1, 0), (0.5, 1)]):
        G.add_node(i, pos=np.array(pos, dtype=float))
    G.add_edge(0, 1)
    G.add_edge(1, 2)
    G.add_edge(2, 0)
    mesh = NetworkMesh(G, N=1)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y)
    solver = Solver(asm, options=SolverOptions(method="schur"))
    solver.assemble()
    with pytest.raises(RuntimeError):
        solver.solve()


def test_float32_serving_mode():
    """SolverOptions(dtype='float32') runs the whole fused solve in single
    precision (the float32 serving mode) within ~1e-5 of the f64 result."""
    G = network_generation.make_arterial_tree(N=4, direction=np.array([0.1, 1, 0]))
    mesh = NetworkMesh(G, N=4, color_strategy="fast")

    def go(dtype):
        asm = HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=p_bc_y, R=1.0 / mesh.edge_radius**4)
        s = Solver(asm, options=SolverOptions(dtype=dtype))
        s.assemble()
        return np.concatenate([f.values for f in s.solve()])

    x64, x32 = go("float64"), go("float32")
    rel = np.max(np.abs(x64 - x32)) / np.max(np.abs(x64))
    assert rel < 1e-4, rel


@pytest.mark.parametrize("flux_degree", [1, 2])
def test_float32_output_contract(flux_degree):
    """dtype='float64' + output_dtype='float32' (the mixed serving
    contract) solves in full f64 and only rounds the outputs — so the
    result must sit at f32 *rounding* distance from the all-f64 solve
    (~1e-7 rel), an order tighter than the all-f32 solve path.
    flux_degree=1 exercises the blocked executor, 2 the general one."""
    G = network_generation.make_arterial_tree(N=4, direction=np.array([0.1, 1, 0]))
    mesh = NetworkMesh(G, N=4, color_strategy="fast")

    def go(output_dtype):
        asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
        asm.compute_forms(p_bc_ex=p_bc_y, R=1.0 / mesh.edge_radius**4)
        s = Solver(asm, options=SolverOptions(output_dtype=output_dtype))
        s.assemble()
        return np.concatenate([f.values for f in s.solve()])

    x64, x32 = go("same"), go("float32")
    rel = np.max(np.abs(x64 - x32)) / np.max(np.abs(x64))
    assert rel < 1e-6, rel

    # Executor-level contract: the solution blocks leave the program in f32.
    from networks_fenicsx_tpu.solver import build_schur_executor

    asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm.compute_forms(p_bc_ex=p_bc_y, R=1.0 / mesh.edge_radius**4)
    ex = build_schur_executor(
        asm,
        SolverOptions(output_dtype="float32"),
        jit=False,
        outputs="blocks",
        internal_layout=True,
    )
    prepare = getattr(ex, "prepare_args", None)
    args = asm.schur_arguments(device=prepare is None)
    if prepare is not None:
        args = prepare(*args)
    q_T, p_T, lam, *_ = ex(*args)
    assert q_T.dtype == np.float32 and p_T.dtype == np.float32
    assert lam.dtype == np.float32


@pytest.mark.parametrize("flux_degree", [2, 3])
def test_scalar_layout_high_degree(flux_degree):
    """Cellwise-constant R at flux degree >= 2 routes through the scalar
    layout (fixed condensed constants — no per-cell Cholesky, no
    (C, k+1, k+1) tensor) and must match the dense and host LU solvers.
    Pins both the layout choice and the numbers."""
    from networks_fenicsx_tpu.solver import _prepare_edge_data

    G = network_generation.make_tree(3, 1.5, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    rng = np.random.default_rng(7)
    R = rng.uniform(0.5, 3.0, mesh.num_edges)
    sols = {}
    for method in ("schur", "dense", "host_lu"):
        asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
        asm.compute_forms(p_bc_ex=p_bc_y, f=0.8, R=R)
        s = Solver(asm, options=SolverOptions(method=method))
        s.assemble()
        sols[method] = np.concatenate([fn.values for fn in s.solve()])
    np.testing.assert_allclose(sols["schur"], sols["dense"], atol=1e-9)
    np.testing.assert_allclose(sols["schur"], sols["host_lu"], atol=1e-9)

    # layout assertion: scalar rh layout with the fixed (k-1, 2) interior
    asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm.compute_forms(p_bc_ex=p_bc_y, f=0.8, R=R)
    ed = _prepare_edge_data(asm)
    assert ed.mt is None and ed.rh is not None
    (minv,) = ed.interior
    assert minv.ndim == 2 and minv.shape == (flux_degree - 1, 2)


def test_most_general_configuration():
    """k=2 flux + nonzero source + per-edge resistance simultaneously:
    condensed schur == dense == host LU."""
    G = network_generation.make_tree(3, 1.5, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    rng = np.random.default_rng(11)
    R = rng.uniform(0.5, 3.0, mesh.num_edges)
    f = 1.25
    sols = {}
    for method in ("schur", "dense", "host_lu"):
        asm = HydraulicNetworkAssembler(mesh, flux_degree=2)
        asm.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
        s = Solver(asm, options=SolverOptions(method=method))
        s.assemble()
        sols[method] = np.concatenate([fn.values for fn in s.solve()])
    np.testing.assert_allclose(sols["schur"], sols["dense"], atol=1e-9)
    np.testing.assert_allclose(sols["schur"], sols["host_lu"], atol=1e-9)


def test_schur_p_with_source():
    """Continuous-pressure reduced solver with a nonzero source term."""
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=3)

    def go(method):
        asm = HydraulicNetworkAssembler(mesh, flux_degree=2, pressure_degree=1)
        asm.compute_forms(p_bc_ex=p_bc_y, f=0.75)
        s = Solver(asm, options=SolverOptions(method=method, rtol=1e-13))
        s.assemble()
        return np.concatenate([fn.values for fn in s.solve()])

    np.testing.assert_allclose(go("schur_p"), go("dense"), atol=1e-9)


def test_recompute_forms_zero_to_nonzero_f():
    """Regression: a Solver whose executor was built for f=0 must not be
    reused verbatim after compute_forms() switches to a nonzero scalar f
    (the zero-source program variant ignores its f argument)."""
    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=4)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y)  # f defaults to 0
    solver = Solver(asm, options=SolverOptions(method="schur"))
    solver.assemble()
    sol0 = solver.solve()
    p0 = np.array(sol0[-2].values)

    asm.compute_forms(p_bc_ex=p_bc_y, f=2.5)
    solver.assemble()
    sol1 = solver.solve()
    p1 = np.array(sol1[-2].values)
    assert np.max(np.abs(p1 - p0)) > 1e-3, "nonzero f was silently ignored"

    # and the result must agree with an independent direct solve
    _, _, ref = _solve(mesh, "host_lu", f=2.5)
    np.testing.assert_allclose(p1, ref[-2].values, atol=1e-9)


def test_solve_sweep_batched_f_over_zero_f_forms():
    """Regression: batched scalar f through solve_sweep when forms were
    computed with f=None (advertised API shape) must flow through."""
    from networks_fenicsx_tpu import solve_sweep

    G = network_generation.make_tree(2, 1, 3)
    mesh = NetworkMesh(G, N=4)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y)  # f = 0 scalar
    f_batch = np.array([0.0, 1.0, 2.5])[:, None]  # (S, 1) scalar kind
    res = solve_sweep(asm, f=f_batch)

    for s, fval in enumerate(f_batch[:, 0]):
        _, _, ref = _solve(mesh, "host_lu", f=float(fval))
        offs = asm.block_offsets
        M = mesh.num_edge_colors
        p_sweep = np.asarray(res.x[s, offs[M] : offs[M + 1]])
        np.testing.assert_allclose(p_sweep, ref[-2].values, atol=1e-9)


@pytest.mark.parametrize("uniform", [True, False])
def test_blocks_executor_matches_flat(uniform: bool):
    """outputs="blocks" (j-major serving contract) must equal the flat
    global vector elementwise, for both the uniform closed-form path and
    the generic per-cell condensation path."""
    from networks_fenicsx_tpu.solver import (
        SolverOptions,
        _flatten_blocks_host,
        build_schur_executor,
    )

    G = network_generation.make_tree(4, 1.0, 2.0)
    mesh = NetworkMesh(G, N=3)
    asm = HydraulicNetworkAssembler(mesh)
    rng = np.random.default_rng(7)
    if uniform:
        R = rng.uniform(0.5, 2.0, mesh.num_edges)  # per-edge -> uniform path
    else:
        R = rng.uniform(0.5, 2.0, mesh.num_cells)  # per-cell -> generic path
    asm.compute_forms(p_bc_ex=lambda x: x[0] + x[1], f=1.3, R=R)

    flat = build_schur_executor(asm, SolverOptions(), jit=False)
    blocks = build_schur_executor(asm, SolverOptions(), jit=False, outputs="blocks")
    args = asm.schur_arguments()
    x, _, _, _, finite_f = flat(*args)
    q_T, p_T, lam, _, _, _, finite_b = blocks(*args)
    assert q_T.shape == (mesh.N + 1, mesh.num_edges)
    assert p_T.shape == (mesh.N, mesh.num_edges)
    np.testing.assert_allclose(
        _flatten_blocks_host(q_T, p_T, lam, mesh.edge_color),
        np.asarray(x),
        rtol=0,
        atol=1e-14,
    )
    assert bool(finite_f) and bool(finite_b)


def test_solver_factorize_reuse_and_fallback():
    """Solver.factorize(): rhs-only re-solves while R is unchanged
    (method == 'schur_factorized', matches host LU), silent fused-path
    fallback the moment R changes, ValueError outside the fast-path
    envelopes.  Reference analog: KSP retains the MUMPS factorization
    across solves (solver.py:58-65)."""
    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(21)
    G = network_generation.make_tree(5, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    E = mesh.num_edges
    R = rng.uniform(0.5, 2.0, E)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
    solver = Solver(asm)
    solver.factorize()
    for _ in range(2):
        asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
        solver.solve()
        assert solver.info.method == "schur_factorized"
        ref_solver = Solver(asm, options=SolverOptions(method="host_lu"))
        ref_solver.solve()
        ref = np.asarray(ref_solver.solution_vector())
        got = np.asarray(solver.solution_vector())
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(got, ref, atol=1e-11 * scale)
    # R change: drops the stale factor, fused path takes over, still right
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R * 1.5)
    solver.solve()
    assert solver.info.method != "schur_factorized"
    ref_solver = Solver(asm, options=SolverOptions(method="host_lu"))
    ref_solver.solve()
    ref = np.asarray(ref_solver.solution_vector())
    got = np.asarray(solver.solution_vector())
    np.testing.assert_allclose(got, ref, atol=1e-11 * max(1.0, np.abs(ref).max()))
    # general topology (per-edge R lattice — outside the blocked/DCT
    # envelopes): the TreeFactorization serves it
    Gc = network_generation.make_grid(4, 3)
    mc = NetworkMesh(Gc, N=1)
    ac = HydraulicNetworkAssembler(mc)
    Rc = rng.uniform(0.5, 2.0, mc.num_edges)
    ac.compute_forms(p_bc_ex=lambda x: x[0], f=0.2, R=Rc)
    sc = Solver(ac)
    sc.factorize()
    ac.compute_forms(p_bc_ex=lambda x: 2.0 * x[0] + x[1], f=0.5, R=Rc)
    sc.solve()
    assert sc.info.method == "schur_factorized"
    ref_c = Solver(ac, options=SolverOptions(method="host_lu"))
    ref_c.solve()
    refv = np.asarray(ref_c.solution_vector())
    gotv = np.asarray(sc.solution_vector())
    np.testing.assert_allclose(gotv, refv, atol=1e-10 * max(1.0, np.abs(refv).max()))
    # outside every factorization envelope (quad-mode callable R): clear error
    aq = HydraulicNetworkAssembler(mc)
    aq.compute_forms(p_bc_ex=lambda x: x[0], R=lambda x: 1.0 + 0.5 * x[0] ** 2)
    with pytest.raises(ValueError, match=r"factorize\(\) requires"):
        Solver(aq).factorize()


def test_solver_factorize_kind_change_falls_back():
    """A compute_forms() that changes the coefficient KIND after
    factorize() invalidates the factor (a kind change would feed the
    wrong layout into the cached solve program)."""
    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(6)
    G = network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    E = mesh.num_edges
    R = rng.uniform(0.5, 2.0, E)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=0.4, R=R)  # scalar f
    solver = Solver(asm)
    solver.factorize()
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
    solver.solve()
    assert solver.info.method != "schur_factorized"
    ref_solver = Solver(asm, options=SolverOptions(method="host_lu"))
    ref_solver.solve()
    ref = np.asarray(ref_solver.solution_vector())
    got = np.asarray(solver.solution_vector())
    np.testing.assert_allclose(got, ref, atol=1e-11 * max(1.0, np.abs(ref).max()))


def test_solver_factorize_staleness_check_is_o1(monkeypatch):
    """The factor-reuse staleness check must not hash the full R buffer on
    every rhs-only solve: solves WITHOUT an intervening compute_forms()
    never hash, a read-only (immutable) R never hashes on identity, and a
    WRITEABLE same-object R hashes exactly once per compute_forms() call
    (identity cannot prove unchanged bytes for a mutable buffer — see
    test_solver_factorize_inplace_mutation_not_stale)."""
    import hashlib

    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(33)
    G = network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    E = mesh.num_edges
    R = rng.uniform(0.5, 2.0, E)
    R.setflags(write=False)  # immutable buffer: identity => unchanged
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
    solver = Solver(asm)
    solver.factorize()

    calls = {"n": 0}
    real_sha1 = hashlib.sha1

    def counting_sha1(*args, **kwargs):
        calls["n"] += 1
        return real_sha1(*args, **kwargs)

    monkeypatch.setattr(hashlib, "sha1", counting_sha1)

    # rhs-only serving loop: no compute_forms at all — zero hashing
    for _ in range(3):
        solver.solve()
        assert solver.info.method == "schur_factorized"
    assert calls["n"] == 0

    # steady serving loop, SAME read-only R object per compute_forms —
    # still zero hashing (identity is trustworthy for immutable buffers)
    for _ in range(3):
        asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
        solver.solve()
        assert solver.info.method == "schur_factorized"
    assert calls["n"] == 0

    # WRITEABLE same-object R: one hash per compute_forms (bytes may have
    # changed), factor still reused while they match
    Rw = np.array(R)  # writeable copy, same bytes
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=Rw)
    solver.solve()
    assert solver.info.method == "schur_factorized"
    assert calls["n"] == 1
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=Rw)
    solver.solve()
    assert solver.info.method == "schur_factorized"
    assert calls["n"] == 2
    # ...but subsequent rhs-only solves stay free
    solver.solve()
    assert solver.info.method == "schur_factorized"
    assert calls["n"] == 2

    # a genuinely different R falls back to the fused path (one hash)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.asarray(R) * 1.5)
    solver.solve()
    assert solver.info.method != "schur_factorized"
    assert calls["n"] == 3


def test_solver_factorize_inplace_mutation_not_stale():
    """In-place mutation of the SAME R buffer between compute_forms()
    calls must not serve the stale factorization: identity does not imply
    unchanged bytes for a writeable array."""
    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(7)
    G = network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    E = mesh.num_edges
    R = rng.uniform(0.5, 2.0, E)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    solver = Solver(asm)
    solver.factorize()
    solver.solve()
    assert solver.info.method == "schur_factorized"

    R *= 3.0  # same object, different bytes
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    solver.solve()
    assert solver.info.method != "schur_factorized"
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    got = np.asarray(solver.solution_vector())
    np.testing.assert_allclose(
        got, refv, atol=1e-10 * max(1.0, np.abs(refv).max())
    )


def test_solver_factorize_mutate_then_freeze_not_stale():
    """A buffer mutated while WRITEABLE and frozen afterwards must not
    serve the stale factorization: immutability has to hold at both ends
    of the identity check (snapshot time and solve time)."""
    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(11)
    G = network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)  # writeable snapshot
    solver = Solver(asm)
    solver.factorize()
    solver.solve()
    assert solver.info.method == "schur_factorized"

    R *= 3.0
    R.setflags(write=False)  # freeze AFTER mutating
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    solver.solve()
    assert solver.info.method != "schur_factorized"
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    np.testing.assert_allclose(
        np.asarray(solver.solution_vector()),
        refv,
        atol=1e-10 * max(1.0, np.abs(refv).max()),
    )


def test_solver_factorize_readonly_view_of_writeable_base_not_stale():
    """A read-only VIEW over a writeable base changes bytes when the base
    is mutated — the staleness signal must not treat it as immutable."""
    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(12)
    G = network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    base = rng.uniform(0.5, 2.0, mesh.num_edges)
    Rv = base[:]
    Rv.setflags(write=False)  # read-only view, writeable base
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=Rv)
    solver = Solver(asm)
    solver.factorize()
    solver.solve()
    assert solver.info.method == "schur_factorized"

    base *= 3.0  # mutate underneath the frozen view
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=Rv)
    solver.solve()
    assert solver.info.method != "schur_factorized"
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    np.testing.assert_allclose(
        np.asarray(solver.solution_vector()),
        refv,
        atol=1e-10 * max(1.0, np.abs(refv).max()),
    )


def test_solver_factorize_irregular_forest():
    """Solver.factorize() on a forest that is NOT blocked-eligible
    (irregular branching): TreeFactorization must execute real peel
    rounds — the forest fast path's empty rounds previously made it
    return lambda = 0 silently."""
    from networks_fenicsx_tpu import network_generation

    rng = np.random.default_rng(11)
    # keep=0.0: spanning tree of a Delaunay web — an irregular forest
    G = network_generation.make_random_network(120, keep=0.0, seed=5)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    E = mesh.num_edges
    R = rng.uniform(0.5, 2.0, E)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=rng.uniform(-1, 1, E), R=R)
    solver = Solver(asm)
    solver.factorize()
    solver.solve()
    assert solver.info.method == "schur_factorized"
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    got = np.asarray(solver.solution_vector())
    scale = max(1.0, np.abs(refv).max())
    assert np.abs(refv).max() > 1e-6  # a zero reference would prove nothing
    np.testing.assert_allclose(got, refv, atol=1e-10 * scale)


def test_solver_factorize_survives_f_zero_flip():
    """Switching f between zero and nonzero is exactly the rhs-only
    serving contract — it must NOT drop the cached factorization (the
    factorization solve paths always process f at runtime; only a
    coefficient KIND change invalidates)."""
    from networks_fenicsx_tpu import network_generation

    G = network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    rng = np.random.default_rng(2)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    R.setflags(write=False)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)  # f = 0 default
    solver = Solver(asm)
    solver.factorize()
    solver.solve()
    assert solver.info.method == "schur_factorized"

    # nonzero scalar source: same kinds, f_zero flips — factor must hold
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=0.7, R=R)
    solver.solve()
    assert solver.info.method == "schur_factorized"
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    got = np.asarray(solver.solution_vector())
    np.testing.assert_allclose(
        got, refv, atol=1e-10 * max(1.0, np.abs(refv).max())
    )
    # and back to zero source
    asm.compute_forms(p_bc_ex=lambda x: 2.0 * x[1], R=R)
    solver.solve()
    assert solver.info.method == "schur_factorized"


def test_explicit_tree_method_rejects_huge_dense_core():
    """schur_method='tree' on a large cyclic core must engage the sparse
    core elimination (same envelope as 'auto') or refuse loudly — never
    materialise an O(core²) dense factor."""
    from networks_fenicsx_tpu import network_generation

    G = network_generation.make_grid(30, 30, arrays=True)
    mesh = NetworkMesh(G, N=1)
    asm = HydraulicNetworkAssembler(mesh)
    rng = np.random.default_rng(3)
    asm.compute_forms(
        p_bc_ex=lambda x: x[0], R=rng.uniform(0.5, 2.0, mesh.num_edges)
    )
    solver = Solver(asm, options=SolverOptions(schur_method="tree"))
    solver.solve()  # 841-node core: sparse elimination, not dense
    ref = Solver(asm, options=SolverOptions(method="host_lu"))
    ref.solve()
    refv = np.asarray(ref.solution_vector())
    got = np.asarray(solver.solution_vector())
    np.testing.assert_allclose(
        got, refv, atol=1e-10 * max(1.0, np.abs(refv).max())
    )
