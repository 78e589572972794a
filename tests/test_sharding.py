"""Multi-device (8 virtual CPU devices) sharded solve == serial solve.

The analog of the reference CI's ``mpiexec -n {2,3,4}`` runs
(reference ``.github/workflows/test_package.yml:33-45``): the same program
partitioned over more devices must produce identical answers.
"""

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
from networks_fenicsx_tpu.parallel import ShardedNetworkSolver


def p_bc_y(x):
    return x[1]


def _serial_solution(mesh, flux_degree=1, f=None, R=None):
    asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
    solver = Solver(asm, options=SolverOptions(method="schur"))
    solver.assemble()
    return asm, solver.solve()


@pytest.mark.parametrize("n_devices", [1, 2, 8])
@pytest.mark.parametrize("n", [3, 5])
def test_sharded_matches_serial(n: int, n_devices: int):
    devices = jax.devices()[:n_devices]
    G = network_generation.make_tree(n, 1.0, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy="largest_first")
    asm, serial = _serial_solution(mesh)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y)
    sharded_solver = ShardedNetworkSolver(asm2, devices=devices)
    sharded_solver.assemble()
    sharded = sharded_solver.solve()

    for fs, fd in zip(serial, sharded):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-12)


def test_sharded_edge_count_not_divisible():
    """7 segments over 8 devices forces padding; answers must not change."""
    G = network_generation.make_tree(3, 1.0, 2.0)  # 7 edges
    mesh = NetworkMesh(G, N=2)
    asm, serial = _serial_solution(mesh)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y)
    sharded = ShardedNetworkSolver(asm2, devices=jax.devices()[:8])
    sharded.assemble()
    out = sharded.solve()
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-12)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_sharded_large_core_matches_serial(n_devices):
    """A web whose cycle core gets a sparse-core plan: the general pipeline
    keeps λ replicated and the flux sharded over every device, and its
    answer matches the serial solve."""
    G = network_generation.make_random_network(1500, keep=0.7, seed=3, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    R = np.random.default_rng(0).uniform(0.5, 3.0, mesh.num_edges)
    _, serial = _serial_solution(mesh, R=R)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R)
    devices = jax.devices()[:n_devices]
    sharded = ShardedNetworkSolver(asm2, devices=devices)
    sharded.assemble()
    out = sharded.solve()
    assert sharded.info.method == "schur_sharded"
    assert sharded._tree_plan.core_plan is not None
    (_, _), (q_edge, _, lam) = sharded.device_io
    assert lam.sharding.is_fully_replicated
    assert {s.device for s in lam.addressable_shards} == set(devices)
    assert {s.device for s in q_edge.addressable_shards} == set(devices)
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10)


def test_sharded_cg_matches_dense():
    """Distributed matrix-free CG Schur solve == replicated dense solve."""
    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=1, color_strategy="smallest_last")
    asm, serial = _serial_solution(mesh)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y)
    sharded = ShardedNetworkSolver(
        asm2, devices=jax.devices()[:4], schur_method="cg"
    )
    sharded.assemble()
    out = sharded.solve()
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8)])
def test_sharded_sweep_2d_mesh(mesh_shape):
    """Scenario × edge 2D-mesh sweep == serial vmapped sweep."""
    from networks_fenicsx_tpu import solve_sweep
    from networks_fenicsx_tpu.parallel.sweep import sharded_sweep

    if len(jax.devices()) < mesh_shape[0] * mesh_shape[1]:
        pytest.skip("needs more devices than available")

    G = network_generation.make_tree(4, 1.0, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    R0 = np.linspace(1.0, 2.0, mesh.num_edges)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R0)
    rng = np.random.default_rng(1)
    R_batch = R0[None, :] * rng.uniform(0.5, 2.0, (6, mesh.num_edges))
    ref = solve_sweep(asm, R=R_batch)
    out = sharded_sweep(asm, R_batch, mesh_shape=mesh_shape)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-12)


def test_sharded_higher_degree_and_source():
    G = network_generation.make_tree(4, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="smallest_last")
    asm, serial = _serial_solution(mesh, flux_degree=2, f=1.5)

    asm2 = HydraulicNetworkAssembler(mesh, flux_degree=2)
    asm2.compute_forms(p_bc_ex=p_bc_y, f=1.5)
    sharded = ShardedNetworkSolver(asm2, devices=jax.devices()[:4])
    sharded.assemble()
    out = sharded.solve()
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-12)


def test_sharded_deeper_tree_with_radii():
    """1023-edge arterial-like problem across 8 devices: level elimination
    under shard_map with per-edge resistance."""
    G = network_generation.make_arterial_tree(N=8, direction=np.array([0.1, 1.0, 0.0]))
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    R = 1.0 / mesh.edge_radius**4

    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R)
    serial_solver = Solver(asm, options=SolverOptions(method="schur"))
    serial_solver.assemble()
    serial = serial_solver.solve()

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R)
    sharded = ShardedNetworkSolver(asm2, devices=jax.devices()[:8])
    sharded.assemble()
    out = sharded.solve()
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10)


# ---------------------------------------------------------------------------
# distributed λ elimination (multiplier axis sharded too)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_tree_dist_matches_serial(n_dev):
    G = network_generation.make_arterial_tree(N=6, direction=np.array([0.1, 1.0, 0.0]))
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    R = 1.0 / mesh.edge_radius**4
    asm, serial = _serial_solution(mesh, R=R)
    sharded = ShardedNetworkSolver(
        asm, devices=jax.devices()[:n_dev], schur_method="tree_dist"
    )
    sharded.assemble()
    out = sharded.solve()
    assert sharded.info.method == "schur_sharded_dist"
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-12)


def test_tree_dist_forest_source_and_degree():
    import networkx as nx

    G = nx.disjoint_union(
        network_generation.make_tree(4, 1.0, 2.0),
        network_generation.make_tree(3, 2.0, 1.0),
    )
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    asm, serial = _serial_solution(mesh, flux_degree=2, f=0.7)
    asm2 = HydraulicNetworkAssembler(mesh, flux_degree=2)
    asm2.compute_forms(p_bc_ex=p_bc_y, f=0.7)
    sharded = ShardedNetworkSolver(asm2, schur_method="tree_dist")
    sharded.assemble()
    out = sharded.solve()
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-12)


def test_tree_dist_large_scale():
    """VERDICT round-1 item 3: the λ stage must scale beyond one device.
    n=18 binary tree: B = 131,071 multipliers over 8 devices — per-device
    local node count is exactly B/8 (plan.B_loc) and sharded == serial at
    1e-10."""
    G = network_generation.make_tree(18, 1.0, 1.0)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    asm, serial = _serial_solution(mesh)
    sharded = ShardedNetworkSolver(asm, schur_method="tree_dist")
    sharded.assemble()
    out = sharded.solve()
    plan = sharded._dist_plan
    B = mesh.num_multipliers
    D = len(jax.devices())
    assert plan.B_loc <= -(-B // D) + len(plan.level_offsets)  # ~B/D (+pads)
    assert plan.Tn <= 64
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10)


def test_tree_dist_chain_fallback():
    """Chain-like bifurcation graphs degenerate the subtree partition (the
    top tree is O(B)); the planner must decline rather than blow memory."""
    import networkx as nx

    from networks_fenicsx_tpu.parallel.distributed_tree import plan_distributed_tree
    from networks_fenicsx_tpu.solver import _plan_tree_elimination

    G = nx.DiGraph()
    n_nodes = 40
    for i in range(n_nodes):
        G.add_node(i, pos=np.array([float(i), 0.0]))
    for i in range(n_nodes - 1):
        G.add_edge(i, i + 1)
    mesh = NetworkMesh(G, N=1)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0])
    plan = plan_distributed_tree(asm, _plan_tree_elimination(asm), D=4, max_T=8)
    assert plan is None  # path graph: top tree is ~3/4 of all nodes

    # auto mode must still solve it (replicated path)
    sharded = ShardedNetworkSolver(asm, schur_method="auto")
    sharded.assemble()
    out = sharded.solve()
    serial_solver = Solver(asm, options=SolverOptions(method="schur"))
    serial_solver.assemble()
    serial = serial_solver.solve()
    for fs, fd in zip(serial, out):
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-12)


# ----------------------------------------------------------------------
# Blocked-sibling sharded path (round 3): the serial fast layout, multi-chip
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_blocked_matches_serial(n_devices):
    """The sharded blocked executor (slice/concat per-device programs +
    one top-tree psum) equals the serial blocked solve to 1e-11."""
    devices = jax.devices()[:n_devices]
    G = network_generation.make_tree(6, 1.0, 2.0)
    mesh = NetworkMesh(G, N=4, color_strategy="fast")
    rng = np.random.default_rng(17)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    f = rng.uniform(-1.0, 1.0, mesh.num_edges)
    asm, serial = _serial_solution(mesh, f=f, R=R)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
    sharded_solver = ShardedNetworkSolver(asm2, devices=devices)
    sharded_solver.assemble()
    sharded = sharded_solver.solve()
    assert sharded_solver.info.method == "schur_sharded_blocked"
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


def test_sharded_blocked_arterial_poiseuille():
    """Arterial tree with per-edge Poiseuille resistance (the BASELINE
    benchmark configuration) rides the blocked sharded path."""
    G = network_generation.make_arterial_tree(N=6, direction=np.array([0.1, 1.0, 0.0]))
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    R = 1.0 / mesh.edge_radius**4
    asm, serial = _serial_solution(mesh, R=R)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R)
    sharded_solver = ShardedNetworkSolver(asm2)
    sharded_solver.assemble()
    sharded = sharded_solver.solve()
    assert sharded_solver.info.method == "schur_sharded_blocked"
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


def test_sharded_blocked_forced_raises_when_infeasible():
    """schur_method='blocked' on a non-divisible topology raises clearly."""
    if len(jax.devices()) not in (3, 5, 6, 7, 8):
        pytest.skip("needs a device count no tree level width divides")
    G = network_generation.make_tree(3, 1.0, 2.0)  # level widths 1, 2, 4
    mesh = NetworkMesh(G, N=2)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y)
    solver = ShardedNetworkSolver(asm, schur_method="blocked")  # 8 devices
    solver.assemble()
    with pytest.raises(ValueError, match="blocked"):
        solver.solve()


def test_sharded_blocked_fallback_general():
    """Topologies outside the blocked/grid fast-path envelopes fall back
    to the general sharded pipeline under schur_method='auto' and still
    match serial.  (Per-edge R disqualifies the lattice DCT plan, so a
    cyclic lattice with heterogeneous resistance exercises the general
    psum pipeline — a uniform lattice now engages schur_sharded_grid,
    pinned in test_grid_sharded.py.)"""
    G = network_generation.make_grid(4, 4, arrays=True)  # cyclic lattice
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    rng = np.random.default_rng(2)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm, serial = _serial_solution(mesh, R=R)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R)
    solver = ShardedNetworkSolver(asm2)
    solver.assemble()
    sharded = solver.solve()
    assert solver.info.method in ("schur_sharded", "schur_sharded_dist")
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10 * scale)


def test_sharded_blocked_large_scale():
    """n=16 tree (65,535 edges, 32,767 multipliers) over 8 devices: the
    cut lands at level 3 (|T| = 7), every device owns one complete
    subtree, and sharded == serial blocked at 1e-11."""
    from networks_fenicsx_tpu import ArrayNetwork  # noqa: F401 (import check)

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")

    G = network_generation.make_tree(16, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=1, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y)
    solver = ShardedNetworkSolver(asm)
    solver.assemble()
    sol = solver.solve()
    assert solver.info.method == "schur_sharded_blocked"
    plan = solver._blocked_exec.plan
    assert plan.Tn == 7 and plan.c == 1
    assert plan.B_sub * plan.D + plan.Tn == mesh.num_multipliers

    asm_s = HydraulicNetworkAssembler(mesh)
    asm_s.compute_forms(p_bc_ex=p_bc_y)
    ser = Solver(asm_s)
    ser.assemble()
    sol_s = ser.solve()
    for a, b in zip(sol_s, sol):
        scale = max(1.0, float(np.max(np.abs(a.values))))
        np.testing.assert_allclose(a.values, b.values, atol=1e-11 * scale)


def test_sharded_blocked_kary_three_devices():
    """A 3-ary tree over 3 devices: the K-ary walk drives the sharded
    blocked plan (cut at the width-3 level, one subtree per device)."""
    if len(jax.devices()) < 3:
        pytest.skip("needs >= 3 devices")
    from _topologies import kary_tree

    G = kary_tree(3, 2)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    rng = np.random.default_rng(23)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm, serial = _serial_solution(mesh, R=R)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R)
    solver = ShardedNetworkSolver(asm2, devices=jax.devices()[:3])
    solver.assemble()
    sharded = solver.solve()
    assert solver.info.method == "schur_sharded_blocked"
    assert solver._blocked_exec.plan.D == 3
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


def test_sharded_blocked_indivisible_device_count_falls_back():
    """6 devices on a binary tree (level widths 2^l): no level divides 6,
    so auto falls back to the general sharded path and still matches."""
    if len(jax.devices()) < 6:
        pytest.skip("needs >= 6 devices")
    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    asm, serial = _serial_solution(mesh)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y)
    solver = ShardedNetworkSolver(asm2, devices=jax.devices()[:6])
    solver.assemble()
    sharded = solver.solve()
    assert solver.info.method in ("schur_sharded", "schur_sharded_dist")
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


def test_sharded_blocked_no_top_tree():
    """A forest of 8 boundary-fed subtrees over 8 devices cuts at level 0:
    |T| = 0, no psum at all — each device solves its subtree
    independently; results still match serial."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    import networkx as nx

    G = nx.DiGraph()
    nid = 0
    for k in range(8):
        x0 = 3.0 * k
        # boundary -> root -> {leaf, leaf}: one bifurcation per component
        ids = {}
        for name, (dx, y) in {
            "in": (0.0, 0.0), "root": (0.0, 1.0),
            "l1": (-1.0, 2.0), "l2": (1.0, 2.0),
        }.items():
            G.add_node(nid, pos=np.array([x0 + dx, y]))
            ids[name] = nid
            nid += 1
        G.add_edge(ids["in"], ids["root"])
        G.add_edge(ids["root"], ids["l1"])
        G.add_edge(ids["root"], ids["l2"])
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    rng = np.random.default_rng(31)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm, serial = _serial_solution(mesh, R=R)

    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R)
    solver = ShardedNetworkSolver(asm2)
    solver.assemble()
    sharded = solver.solve()
    assert solver.info.method == "schur_sharded_blocked"
    assert solver._blocked_exec.plan.Tn == 0
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_blocked_fuzz_uniform_forests(seed):
    """Random uniformly-K-ary trees with random coefficients and random
    device counts: sharded blocked == serial whenever the plan engages;
    the general path covers it otherwise."""
    from _topologies import kary_tree

    rng = np.random.default_rng(100 + seed)
    K = int(rng.integers(2, 4))
    depth = int(rng.integers(1, 3))
    G = kary_tree(K, depth)
    N = int(rng.integers(1, 5))
    mesh = NetworkMesh(G, N=N, color_strategy="fast")
    R = rng.uniform(0.2, 5.0, mesh.num_edges)
    f = rng.uniform(-2.0, 2.0, mesh.num_edges)
    asm, serial = _serial_solution(mesh, R=R, f=f)

    n_dev = int(rng.choice([1, 2, 4, 8]))
    asm2 = HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=p_bc_y, R=R, f=f)
    solver = ShardedNetworkSolver(asm2, devices=jax.devices()[:n_dev])
    solver.assemble()
    sharded = solver.solve()
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10 * scale)


def test_sharded_blocked_sweep_matches_individual():
    """The 2-D sharded sweep routes through the blocked elimination on
    tree networks (no dense per-scenario Cholesky) and matches
    per-scenario serial solves — including a nonzero fixed source, which
    the legacy dense path refuses."""
    from networks_fenicsx_tpu.parallel.sweep import sharded_sweep

    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    rng = np.random.default_rng(41)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    f = rng.uniform(-1.0, 1.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R0, f=f)
    scales = np.array([0.7, 1.0, 1.8, 3.0, 5.5])
    res = sharded_sweep(
        asm, R0[None, :] * scales[:, None],
        mesh_shape=(2, min(4, max(1, len(jax.devices()) // 2))),
    )
    xs = np.asarray(res.x)
    assert xs.shape[0] == scales.size
    for i in (0, 2, 4):
        asm_i = HydraulicNetworkAssembler(mesh)
        asm_i.compute_forms(p_bc_ex=p_bc_y, R=R0 * scales[i], f=f)
        s = Solver(asm_i)
        s.assemble()
        sol = s.solve()
        x_i = np.concatenate([np.ravel(fn.values) for fn in sol])
        scale = max(1.0, float(np.max(np.abs(x_i))))
        np.testing.assert_allclose(xs[i], x_i, atol=1e-10 * scale)


def test_sharded_blocked_sweep_scenarios_on_edges_axis_only():
    """mesh_shape (1, D): all devices on the edge axis."""
    from networks_fenicsx_tpu.parallel.sweep import sharded_sweep

    n_dev = len(jax.devices())
    if n_dev < 2:
        pytest.skip("needs >= 2 devices")
    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    R0 = np.linspace(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R0)
    res = sharded_sweep(asm, R0[None, :] * np.array([1.0, 2.0])[:, None],
                        devices=jax.devices()[:2], mesh_shape=(1, 2))
    xs = np.asarray(res.x)
    asm_1 = HydraulicNetworkAssembler(mesh)
    asm_1.compute_forms(p_bc_ex=p_bc_y, R=2.0 * R0)
    s = Solver(asm_1)
    s.assemble()
    sol = s.solve()
    x_1 = np.concatenate([np.ravel(fn.values) for fn in sol])
    np.testing.assert_allclose(xs[1], x_1, atol=1e-10)


def test_sharded_blocked_recompute_forms_changes_modes():
    """Switching coefficient kinds between solves (per-edge R -> scalar R)
    rebuilds the blocked executor instead of mispermuting stale args."""
    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    R0 = np.linspace(0.5, 2.0, mesh.num_edges)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R0)
    solver = ShardedNetworkSolver(asm)
    solver.assemble()
    solver.solve()
    assert solver.info.method == "schur_sharded_blocked"

    asm.compute_forms(p_bc_ex=p_bc_y, R=3.0)  # scalar kind now
    solver.assemble()
    sol2 = solver.solve()
    asm_s = HydraulicNetworkAssembler(mesh)
    asm_s.compute_forms(p_bc_ex=p_bc_y, R=3.0)
    ser = Solver(asm_s)
    ser.assemble()
    ref = ser.solve()
    for a, b in zip(ref, sol2):
        np.testing.assert_allclose(a.values, b.values, atol=1e-11)


def test_sharded_forced_blocked_raises_every_solve():
    """A forced schur_method='blocked' on an infeasible topology raises on
    EVERY solve — never a silent fall-through to the general pipeline."""
    if len(jax.devices()) not in (3, 5, 6, 7, 8):
        pytest.skip("needs a device count no tree level width divides")
    G = network_generation.make_tree(3, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y)
    solver = ShardedNetworkSolver(asm, schur_method="blocked")
    solver.assemble()
    with pytest.raises(ValueError, match="blocked"):
        solver.solve()
    with pytest.raises(ValueError, match="blocked"):
        solver.solve()  # second attempt must raise too


@pytest.mark.parametrize("topology", ["tree", "grid"])
def test_sharded_coefficients_snapshot_at_assemble(topology):
    """Reference semantics, uniform across the blocked and general paths:
    solve() uses the coefficients captured at assemble() time; a
    compute_forms() between assemble() and solve() takes effect only
    after the next assemble() (reference solver.py:90-101)."""
    if topology == "tree":
        G = network_generation.make_tree(4, 1.0, 2.0)
    else:
        G = network_generation.make_grid(3, 3, arrays=True)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    R1 = np.linspace(0.5, 2.0, mesh.num_edges)
    R2 = R1 * 3.0
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R1)
    solver = ShardedNetworkSolver(asm)
    solver.assemble()
    x1 = np.concatenate([f.values.ravel() for f in solver.solve()])

    asm.compute_forms(p_bc_ex=p_bc_y, R=R2)  # NOT followed by assemble()
    x_stale = np.concatenate([f.values.ravel() for f in solver.solve()])
    np.testing.assert_allclose(x_stale, x1, atol=1e-14)  # still R1

    solver.assemble()
    x2 = np.concatenate([f.values.ravel() for f in solver.solve()])
    asm_ref = HydraulicNetworkAssembler(mesh)
    asm_ref.compute_forms(p_bc_ex=p_bc_y, R=R2)
    ser = Solver(asm_ref)
    ser.assemble()
    x_ref = np.concatenate([f.values.ravel() for f in ser.solve()])
    np.testing.assert_allclose(x2, x_ref, atol=1e-11)


def test_sharded_blocked_sweep_rejects_bad_shape():
    """R with the wrong column count raises clearly (not silent column
    truncation)."""
    from networks_fenicsx_tpu.parallel.sweep import sharded_sweep

    G = network_generation.make_tree(4, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y, R=np.ones(mesh.num_edges))
    with pytest.raises(ValueError, match="num_edges"):
        sharded_sweep(asm, np.ones((2, mesh.num_edges + 5)))


@pytest.mark.parametrize("flux_degree", [2, 3])
def test_sharded_blocked_high_degree(flux_degree):
    """Flux degree >= 2 engages the sharded blocked executor (the
    degree-blind elimination + fixed condensed-constant condensation)
    and matches the serial dense solver at 1e-11."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    G = network_generation.make_tree(6, 1.0, 2.0)
    mesh = NetworkMesh(G, N=4, color_strategy="fast")
    rng = np.random.default_rng(17)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    f = rng.uniform(-1.0, 1.0, mesh.num_edges)

    asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
    s = Solver(asm, options=SolverOptions(method="dense"))
    s.assemble()
    serial = s.solve()

    asm2 = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm2.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
    sharded_solver = ShardedNetworkSolver(asm2, devices=jax.devices()[:8])
    sharded_solver.assemble()
    sharded = sharded_solver.solve()
    assert sharded_solver.info.method == "schur_sharded_blocked"
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


def test_sharded_sweep_high_degree_blocked():
    """Degree-2 resistance sweeps ride the blocked path on the 2-D mesh
    and match the serial dense solver per scenario."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from networks_fenicsx_tpu.parallel.sweep import sharded_sweep

    G = network_generation.make_tree(5, 1.0, 2.0)
    mesh = NetworkMesh(G, N=3, color_strategy="fast")
    rng = np.random.default_rng(5)
    Rb = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh, flux_degree=2)
    asm.compute_forms(p_bc_ex=p_bc_y, f=0.3, R=Rb)
    Rs = rng.uniform(0.5, 2.0, (6, mesh.num_edges))
    x = np.asarray(sharded_sweep(asm, Rs, mesh_shape=(4, 2)).x)

    asm2 = HydraulicNetworkAssembler(mesh, flux_degree=2)
    asm2.compute_forms(p_bc_ex=p_bc_y, f=0.3, R=Rs[2])
    s2 = Solver(asm2, options=SolverOptions(method="dense"))
    s2.assemble()
    ref = np.concatenate([np.asarray(fn.values).ravel() for fn in s2.solve()])
    np.testing.assert_allclose(x[2], ref, atol=1e-10)


@pytest.mark.parametrize("flux_degree", [2, 3])
def test_sharded_general_path_high_degree_cyclic(flux_degree):
    """Cyclic topology at flux degree >= 2 takes the GENERAL sharded
    pipeline (blocked plan inapplicable); the fixed (k-1, 2) interior
    recovery matrix is replicated across devices — never broadcast to an
    O(C) per-cell tensor — and results match host LU."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import networkx as nx

    G = nx.DiGraph()
    pos = {0: (0, 0, 0), 1: (1, 0, 0), 2: (2, 1, 0), 3: (2, -1, 0),
           4: (3, 0, 0), 5: (4, 0, 0)}
    for n_, v in pos.items():
        G.add_node(n_, pos=np.array(v, float))
    for e in [(0, 1), (1, 2), (1, 3), (2, 4), (3, 4), (4, 5)]:
        G.add_edge(*e)

    mesh = NetworkMesh(G, N=3)
    rng = np.random.default_rng(1)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    f = rng.uniform(-1.0, 1.0, mesh.num_edges)
    asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=f, R=R)
    s = Solver(asm, options=SolverOptions(method="host_lu"))
    s.assemble()
    serial = s.solve()

    asm2 = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm2.compute_forms(p_bc_ex=lambda x: x[0], f=f, R=R)
    sharded_solver = ShardedNetworkSolver(asm2, devices=jax.devices()[:8])
    sharded_solver.assemble()
    (minv,) = sharded_solver._edge_data.interior
    assert minv.ndim == 2 and minv.shape == (flux_degree - 1, 2)
    sharded = sharded_solver.solve()
    assert sharded_solver.info.method != "schur_sharded_blocked"
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-10 * scale)


@pytest.mark.parametrize("flux_degree", [1, 2])
def test_sharded_blocked_per_cell_coefficients(flux_degree):
    """Per-cell R and f now ride the blocked sharded path (j-major
    (N, E_loc) coefficient rows sharded along the edge axis) and match
    the serial dense solver."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    G = network_generation.make_tree(6, 1.0, 2.0)
    mesh = NetworkMesh(G, N=4, color_strategy="fast")
    rng = np.random.default_rng(21)
    R = rng.uniform(0.5, 2.0, mesh.num_cells)
    f = rng.uniform(-1.0, 1.0, mesh.num_cells)

    asm = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
    s = Solver(asm, options=SolverOptions(method="dense"))
    s.assemble()
    serial = s.solve()

    asm2 = HydraulicNetworkAssembler(mesh, flux_degree=flux_degree)
    asm2.compute_forms(p_bc_ex=p_bc_y, f=f, R=R)
    sharded_solver = ShardedNetworkSolver(asm2, devices=jax.devices()[:8])
    sharded_solver.assemble()
    sharded = sharded_solver.solve()
    assert sharded_solver.info.method == "schur_sharded_blocked"
    for fs, fd in zip(serial, sharded):
        scale = max(1.0, float(np.max(np.abs(fs.values))))
        np.testing.assert_allclose(fs.values, fd.values, atol=1e-11 * scale)


def test_sharded_assemble_time_coefficient_kinds():
    """A compute_forms() that changes a coefficient KIND between
    assemble() and solve() must not take effect until the next
    assemble(): solve() consumes the assemble-time snapshot, so the
    executor must be selected for the snapshot's modes (a solve-time
    modes key would pair a scalar-R executor with per-edge buffers and
    silently broadcast element [0])."""
    G = network_generation.make_tree(4, 1.0, 2.0)
    mesh = NetworkMesh(G, N=2, color_strategy="largest_first")
    E = mesh.num_edges
    R_edge = np.linspace(1.0, 2.5, E)

    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc_y, R=R_edge)
    sh = ShardedNetworkSolver(asm, devices=jax.devices()[:2])
    sh.assemble()
    # kind change AFTER assemble: per-edge -> scalar
    asm.compute_forms(p_bc_ex=p_bc_y, R=2.0)
    sol = sh.solve()
    got = np.concatenate([fn.values for fn in sol])

    # must equal the serial solve with the ASSEMBLE-time per-edge R
    _, ref_sol = _serial_solution(mesh, R=R_edge)
    ref = np.concatenate([fn.values for fn in ref_sol])
    np.testing.assert_allclose(got, ref, atol=1e-11 * max(1.0, np.abs(ref).max()))

    # after re-assemble the new scalar R takes effect
    sh.assemble()
    sol2 = sh.solve()
    got2 = np.concatenate([fn.values for fn in sol2])
    _, ref2_sol = _serial_solution(mesh, R=2.0)
    ref2 = np.concatenate([fn.values for fn in ref2_sol])
    np.testing.assert_allclose(got2, ref2, atol=1e-11 * max(1.0, np.abs(ref2).max()))
