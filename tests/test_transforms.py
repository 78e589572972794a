"""Functional-transform capabilities unique to the JAX design:
the fused solve is a pure function, so parameter sweeps batch with vmap
and sensitivities come from jax.grad (adjoint) — no counterpart exists in
the PETSc/MUMPS reference."""

import numpy as np

import jax
import jax.numpy as jnp

from networks_fenicsx_tpu import (
    HydraulicNetworkAssembler,
    NetworkMesh,
    SolverOptions,
    network_generation,
)
from networks_fenicsx_tpu.solver import build_schur_executor


def _setup(n=3, N=3):
    G = network_generation.make_tree(n, 1.0, 2.0)
    mesh = NetworkMesh(G, N=N)
    asm = HydraulicNetworkAssembler(mesh)
    # per-edge resistance so the executor takes an (E,)-shaped R argument
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    executor = build_schur_executor(asm, SolverOptions(), jit=False)
    return mesh, asm, executor, asm.schur_arguments()


def test_vmap_resistance_sweep():
    """Batch 8 resistance scenarios through one vmapped solve."""
    mesh, asm, executor, (R_q, f_q, spbc, epbc) = _setup()
    scales = jnp.linspace(0.5, 4.0, 8)
    R_batch = R_q[None, :] * scales[:, None]

    batched = jax.jit(jax.vmap(lambda R: executor(R, f_q, spbc, epbc)[0]))
    xs = batched(R_batch)
    assert xs.shape == (8, asm.num_dofs)

    # each batch entry must equal its individual solve
    for i in [0, 3, 7]:
        x_i, *_ = executor(R_batch[i], f_q, spbc, epbc)
        np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(x_i), atol=1e-12)

    # physics: scaling R by s scales fluxes by 1/s (linear problem)
    q0 = xs[:, 0]
    np.testing.assert_allclose(
        np.asarray(q0 * scales), np.asarray(q0[0] * scales[0]), rtol=1e-10
    )


def test_grad_through_solve():
    """d(total outflow)/d(R) via reverse-mode AD through the fused solve
    (discrete adjoint), validated against finite differences."""
    mesh, asm, executor, (R_q, f_q, spbc, epbc) = _setup()

    def outflow(R):
        x, *_ = executor(R, f_q, spbc, epbc)
        return x[0]  # first flux dof (root edge inflow)

    g = jax.grad(outflow)(R_q)
    assert g.shape == R_q.shape

    # finite-difference check along a random direction
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.standard_normal(R_q.shape))
    eps = 1e-6
    fd = (outflow(R_q + eps * d) - outflow(R_q - eps * d)) / (2 * eps)
    ad = jnp.vdot(g, d)
    np.testing.assert_allclose(float(ad), float(fd), rtol=1e-5)


def test_solve_sweep_api():
    """Public sweep API: R and boundary-pressure batches in one dispatch."""
    from networks_fenicsx_tpu import solve_sweep

    mesh, asm, executor, (R_q, f_q, spbc, epbc) = _setup()
    S = 5
    scales = np.linspace(1.0, 3.0, S)
    R_batch = np.asarray(R_q)[None, :] * scales[:, None]
    res = solve_sweep(asm, R=R_batch)
    assert res.x.shape == (S, asm.num_dofs)
    # linearity: fluxes scale as 1/R
    q0 = np.asarray(res.x[:, 0])
    np.testing.assert_allclose(q0 * scales, q0[0] * scales[0], rtol=1e-10)
    # per-scenario function materialisation matches a direct solve
    from networks_fenicsx_tpu import Solver, SolverOptions

    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R_batch[2][: mesh.num_edges])
    solver = Solver(asm, options=SolverOptions(method="schur"))
    solver.assemble()
    direct = solver.solve()
    fns = res.functions(2)
    for a, b in zip(fns, direct):
        np.testing.assert_allclose(a.values, b.values, atol=1e-11)

    # boundary-pressure sweep: scaling p_bc scales the solution linearly
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    pb = np.asarray(mesh.vertices[: mesh.num_graph_nodes][:, 1])
    pb_batch = pb[None, :] * np.array([1.0, 2.0, -1.0])[:, None]
    res2 = solve_sweep(asm, p_bc_node_values=pb_batch)
    x0, x1, x2 = (np.asarray(res2.x[i]) for i in range(3))
    np.testing.assert_allclose(x1, 2 * x0, atol=1e-11)
    np.testing.assert_allclose(x2, -x0, atol=1e-11)


def test_grad_wrt_boundary_pressure():
    mesh, asm, executor, (R_q, f_q, spbc, epbc) = _setup()

    def mean_pressure(pb_end):
        x, *_ = executor(R_q, f_q, spbc, pb_end)
        offs = asm.block_offsets
        M = mesh.num_edge_colors
        return jnp.mean(x[offs[M] : offs[M + 1]])

    g = jax.grad(mean_pressure)(epbc)
    eps = 1e-6
    d = jnp.ones_like(epbc)
    fd = (mean_pressure(epbc + eps * d) - mean_pressure(epbc - eps * d)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g, d)), float(fd), rtol=1e-6)


def test_grad_through_blocked_high_degree():
    """Adjoints flow through the blocked degree-2 program (fixed
    condensed constants + interior recovery): jax.grad matches central
    finite differences."""
    G = network_generation.make_tree(3, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh, flux_degree=2)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.linspace(0.5, 2.0, mesh.num_edges))
    ex = build_schur_executor(
        asm, SolverOptions(), outputs="blocks", internal_layout=True
    )
    args = ex.prepare_args(*asm.schur_arguments(device=False))

    def loss(R):
        q_T, p_T, lam, *_ = ex(R, args[1], args[2], args[3])
        return jnp.sum(q_T[0] ** 2)

    g = jax.grad(loss)(jnp.asarray(args[0]))
    eps = 1e-6
    Rp = np.asarray(args[0]).copy()
    Rm = Rp.copy()
    Rp[2] += eps
    Rm[2] -= eps
    fd = (loss(jnp.asarray(Rp)) - loss(jnp.asarray(Rm))) / (2 * eps)
    np.testing.assert_allclose(float(g[2]), float(fd), rtol=1e-6)


def test_solve_sweep_kind_mismatch_raises():
    """A batch whose trailing shape disagrees with the coefficient kind
    fixed by compute_forms raises instead of solving the wrong problem."""
    import pytest

    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        network_generation,
        solve_sweep,
    )

    mesh = NetworkMesh(network_generation.make_tree(3, 1.0, 2.0), N=2)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=0.2)  # scalar-kind f
    with pytest.raises(ValueError, match="coefficient kind"):
        solve_sweep(asm, f=np.ones((3, mesh.num_edges)))


def test_solve_sweep_per_cell_blocked_forest():
    """Per-cell coefficient batches permute correctly into the blocked
    executor's (N, E) j-major layout (regression: the per-edge permutation
    was applied to (S, C) cell batches, scrambling every scenario)."""
    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        Solver,
        SolverOptions,
        network_generation,
        solve_sweep,
    )
    from networks_fenicsx_tpu.solver import _BlockedPlan

    rng = np.random.default_rng(9)
    # B = 8191 > 4096 so the sweep keeps the (blocked) tree path
    G = network_generation.make_tree(14, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    C = mesh.num_edges * mesh.N
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=rng.uniform(0.5, 1.5, C))
    fb = rng.uniform(-1.0, 1.0, (2, C))
    res = solve_sweep(asm, f=fb)
    executor = list(asm._sweep_cache.values())[0][1]
    assert isinstance(executor.blocked_plan, _BlockedPlan)
    X = np.asarray(res.x)
    for i in range(2):
        asm2 = HydraulicNetworkAssembler(mesh)
        asm2.compute_forms(p_bc_ex=lambda x: x[0], f=fb[i])
        s = Solver(asm2, options=SolverOptions(method="host_lu"))
        s.solve()
        ref = np.asarray(s.solution_vector())
        scale = np.abs(ref).max()
        np.testing.assert_allclose(X[i], ref, atol=1e-9 * scale)


def test_solve_sweep_p_bc_blocked_forest():
    """Boundary-pressure batches permute correctly into the blocked
    executor's internal edge order (B > 4096 keeps the blocked tree path;
    linearity in p_bc pins correctness without a host reference)."""
    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        network_generation,
        solve_sweep,
    )
    from networks_fenicsx_tpu.solver import _BlockedPlan

    G = network_generation.make_tree(14, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    pb = np.asarray(mesh.vertices[: mesh.num_graph_nodes][:, 1])
    res = solve_sweep(
        asm, p_bc_node_values=pb[None, :] * np.array([1.0, 2.0, -0.5])[:, None]
    )
    executor = list(asm._sweep_cache.values())[0][1]
    assert isinstance(executor.blocked_plan, _BlockedPlan)
    x0, x1, x2 = (np.asarray(res.x[i]) for i in range(3))
    scale = max(1.0, np.abs(x0).max())
    np.testing.assert_allclose(x1, 2.0 * x0, atol=1e-11 * scale)
    np.testing.assert_allclose(x2, -0.5 * x0, atol=1e-11 * scale)


def test_solve_sweep_scenario_sharding():
    """solve_sweep(devices=...) shards the scenario axis data-parallel and
    matches the single-device sweep exactly (lattice + forest paths)."""
    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        network_generation,
        solve_sweep,
    )

    rng = np.random.default_rng(1)
    devices = jax.devices()
    if len(devices) < 2:
        import pytest

        pytest.skip("needs the multi-device virtual mesh")
    S = len(devices)

    G = network_generation.make_grid(8, 6, arrays=True)
    mesh = NetworkMesh(G, N=2)
    rep = rng.uniform(0.5, 1.5, mesh.num_edges)
    fb = rng.uniform(-1.0, 1.0, (S, mesh.num_edges))
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=rep, R=1.0)
    res_dp = solve_sweep(asm, f=fb, devices=devices)
    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=lambda x: x[0], f=rep, R=1.0)
    res = solve_sweep(asm2, f=fb)
    np.testing.assert_allclose(
        np.asarray(res_dp.x), np.asarray(res.x), atol=1e-12
    )

    import pytest

    with pytest.raises(ValueError, match="divisible"):
        solve_sweep(asm, f=fb[: S - 1], devices=devices)


def test_solve_sweep_cache_keys_on_all_options():
    """The compiled-sweep cache must key on EVERY SolverOptions field: an
    f32 sweep followed by a default-f64 sweep previously reused the f32
    executor silently (cache key was (in_axes, schur_method, modes))."""
    from networks_fenicsx_tpu import Solver, SolverOptions, solve_sweep

    mesh, asm, executor, (R_q, f_q, spbc, epbc) = _setup()
    E = mesh.num_edges
    R_batch = np.asarray(R_q)[None, :E] * np.array([1.0, 2.0])[:, None]
    res32 = solve_sweep(asm, R=R_batch, options=SolverOptions(dtype="float32"))
    res64 = solve_sweep(asm, R=R_batch)
    # the f64 sweep must match a direct f64 solve at f64 accuracy — an
    # accidentally-reused f32 executor sits at ~1e-5
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R_batch[1])
    s = Solver(asm)
    s.solve()
    ref = np.asarray(s.solution_vector())
    err64 = np.max(np.abs(np.asarray(res64.x[1]) - ref))
    assert err64 < 1e-11 * max(1.0, np.abs(ref).max()), err64
    # and the f32 sweep really ran in f32 (sanity that both paths exist)
    err32 = np.max(np.abs(np.asarray(res32.x[1]) - ref))
    assert err32 > err64
