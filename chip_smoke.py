"""On-device smoke check: the solver's main path and every engine on a GPU.

Usage::

    python chip_smoke.py           # one GPU: phases 1-5 below
    python chip_smoke.py --multi   # four GPUs: the sharded paths only

Phases (one process, one card by default):

1. device — JAX must report a GPU; the card's name and power limit are
   read from ``nvidia-smi``.
2. main path — the 16-generation Murray arterial tree at full width
   (65,535 vessels, 5,341,102 dofs, N = 40, R = 1/r⁴, p_bc = y) through
   ``Solver.assemble()/solve()`` (blocked forest executor) against SciPy
   SuperLU of the identical assembled system, ``factorize()`` + rhs-only
   ``solve()``, the float32 serving mode, finiteness and junction
   conservation.
3. engines — every engine a ``bench.py`` stage routes to, at real
   widths: the 512² lattice DCT, the 10k-junction Delaunay web (tree
   multifrontal), the perfusion bed, and a per-edge-R 46² lattice — the
   smallest whose core (2,116 > 2,048) routes to the multifrontal engine,
   which covers it without the 320² stage's compile cost.
4. correctness matrix — small-network checks of every solver method,
   executor variant and sparse-core engine against host LU, goldens or
   each other.
5. card-only pytest tests (``-m gpu``), in this same process.

Every check prints its value beside its tolerance and precision.  The
last line is ``{"ok": true, "device": {...}}`` only when every check
passed; otherwise the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# Full widths of each phase (the bench.py stage configurations).
FULL = {
    "gens": 16, "N": 40,
    "lattice": 512, "dct_f32": 128,
    "web": 10_000, "bed": (5, 96, 64), "mf_lattice": 46,
}
F64 = "f64"
F32_HI = "f32, matmuls at Precision.HIGHEST"


class Checks:
    """Collects named pass/fail checks and prints each as it is made."""

    def __init__(self) -> None:
        self.failed: list[str] = []
        self.count = 0

    def bound(self, name: str, value: float, tol: float, precision: str = F64) -> bool:
        """Pass when ``value <= tol`` (NaN fails)."""
        ok = bool(value <= tol)
        self._log(name, ok, f"{value:.3e} <= {tol:.0e} [{precision}]")
        return ok

    def true(self, name: str, ok: bool, detail: str = "") -> bool:
        self._log(name, bool(ok), detail)
        return bool(ok)

    def _log(self, name: str, ok: bool, detail: str) -> None:
        self.count += 1
        if not ok:
            self.failed.append(name)
        print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)


def rel_err(x, ref) -> float:
    """max|x − ref| / max(1, max|ref|) — the bench's accuracy measure."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / max(1.0, np.abs(ref).max()))


def superlu(asm) -> np.ndarray:
    """SciPy SuperLU solve of the assembler's identical host system."""
    import scipy.sparse.linalg as spla

    A, b = asm.host_system()
    return spla.splu(A).solve(b)


def solve(asm, **opts):
    """``Solver(asm).assemble(); solve()``; returns (solver, functions, x)."""
    from networks_fenicsx_tpu import Solver, SolverOptions

    s = Solver(asm, options=SolverOptions(**opts))
    s.assemble()
    sol = s.solve()
    return s, sol, np.asarray(s.solution_vector())


def junction_imbalance(mesh, sol) -> float:
    """max over junctions of |Σ q_in − Σ q_out|, relative to max |q|."""
    q0 = np.empty(mesh.num_edges)
    q1 = np.empty(mesh.num_edges)
    for fn in sol[:-2]:
        view = mesh.submeshes[fn.space.color]
        per_edge = fn.values.reshape(view.edge_ids.size, -1)
        q0[view.edge_ids] = per_edge[:, 0]
        q1[view.edge_ids] = per_edge[:, -1]
    edges = np.asarray(mesh.edges)
    net = np.zeros(mesh.num_graph_nodes)
    np.add.at(net, edges[:, 1], q1)
    np.add.at(net, edges[:, 0], -q0)
    return float(np.abs(net[mesh.bifurcation_values]).max() / np.abs(q0).max())


def _assembler(mesh, p_bc=lambda x: x[1], **forms):
    from networks_fenicsx_tpu import HydraulicNetworkAssembler

    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc, **forms)
    return asm


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device(n_cards: int = 1) -> dict:
    """Refuse any backend but a GPU; return the device record (with the
    ``nvidia-smi`` name and power limit of each card under ``cards``)."""
    from networks_fenicsx_tpu.utils.platform import gpu_device_record

    rec = gpu_device_record(n_cards)
    print(f"device: {rec['platform']} {rec['kind']}, {n_cards} used", flush=True)
    return rec


def _memory_report(executor, args) -> None:
    """``compiled.memory_analysis()`` of the solve and the device's peak."""
    import jax

    ma = executor.lower(*args).compile().memory_analysis()
    if ma is not None:
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        print("main: memory_analysis " + ", ".join(
            f"{f}={getattr(ma, f, None)}" for f in fields), flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"main: peak_bytes_in_use={stats.get('peak_bytes_in_use', 'not available')}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 2: main path
# ---------------------------------------------------------------------------


def phase_main(chk: Checks, gens: int = FULL["gens"], N: int = FULL["N"]) -> None:
    from networks_fenicsx_tpu import NetworkMesh, Solver
    from networks_fenicsx_tpu.network_generation import make_arterial_tree
    from networks_fenicsx_tpu.solver import _BlockedPlan

    tree = make_arterial_tree(gens, direction=np.array([0.1, 1.0, 0.0]), arrays=True)
    mesh = NetworkMesh(tree, N=N, color_strategy="fast")
    R = 1.0 / mesh.edge_radius**4
    asm = _assembler(mesh, R=R)
    print(f"main: {gens} generations, {mesh.num_edges} vessels, {asm.num_dofs} dofs",
          flush=True)

    t0 = time.perf_counter()
    s, sol, x = solve(asm)
    print(f"main: fused solve (compile + run) {time.perf_counter() - t0:.1f}s", flush=True)
    ex = s._executor
    chk.true("main: blocked forest executor",
             isinstance(getattr(ex, "blocked_plan", None), _BlockedPlan),
             f"method={s.info.method}")
    _memory_report(ex, ex.prepare_args(*asm.schur_arguments(device=False)))

    t0 = time.perf_counter()
    x_lu = superlu(asm)
    print(f"main: SuperLU {time.perf_counter() - t0:.1f}s", flush=True)
    chk.bound("main: fused solve vs SuperLU", rel_err(x, x_lu), 1e-8)
    chk.true("main: solution finite", np.all(np.isfinite(x)))
    chk.bound("main: junction conservation", junction_imbalance(mesh, sol), 1e-10)

    sf = Solver(_assembler(mesh, R=R))
    sf.factorize()
    sf.solve()
    xf = np.asarray(sf.solution_vector())
    chk.true("main: factor reuse engaged", sf.info.method == "schur_factorized",
             f"method={sf.info.method}")
    chk.bound("main: factor reuse vs fused", rel_err(xf, x), 1e-11)
    chk.bound("main: factor reuse vs SuperLU", rel_err(xf, x_lu), 1e-8)

    _, _, x32 = solve(_assembler(mesh, R=R), dtype="float32")
    rel32 = float(np.max(np.abs(x32 - x)) / np.abs(x).max())
    chk.bound("main: float32 serving vs f64", rel32, 1e-4, F32_HI)


# ---------------------------------------------------------------------------
# phase 3: engines at real widths
# ---------------------------------------------------------------------------


def _mf_engaged(asm) -> tuple[bool, dict | None]:
    from networks_fenicsx_tpu.solver import _cached_tree_plan

    plan = _cached_tree_plan(asm, attach=True)
    stats = plan.core_plan.stats if plan is not None and plan.core_plan else None
    return bool(stats and stats.get("mf_fronts")), stats


def phase_lattice_dct(chk: Checks, n: int = FULL["lattice"]) -> None:
    import jax

    from networks_fenicsx_tpu import NetworkMesh, SolverOptions
    from networks_fenicsx_tpu.network_generation import make_grid
    from networks_fenicsx_tpu.solver import _GridPlan, build_schur_executor

    mesh = NetworkMesh(make_grid(n, n, arrays=True), N=1, color_strategy="fast")
    asm = _assembler(mesh, R=1.0)
    ex = build_schur_executor(asm, SolverOptions(schur_method="dct"),
                              outputs="blocks", internal_layout=True)
    engaged = isinstance(getattr(ex, "blocked_plan", None), _GridPlan)
    chk.true(f"lattice {n}²: grid plan engaged", engaged)
    out = ex(*jax.device_put(ex.prepare_args(*asm.schur_arguments(device=False))))
    res = float(out[4]) / max(float(out[5]), 1e-300)
    chk.bound(f"lattice {n}²: relative λ residual", res, 1e-10)


def phase_lattice_f32(chk: Checks, n: int = FULL["dct_f32"]) -> None:
    """Matmul-DCT under dtype=float32: TF32 passes would break 1e-4."""
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_grid

    mesh = NetworkMesh(make_grid(n, n, arrays=True), N=1, color_strategy="fast")
    _, _, x64 = solve(_assembler(mesh, p_bc=lambda x: x[0], R=1.0), schur_method="dct")
    _, _, x32 = solve(_assembler(mesh, p_bc=lambda x: x[0], R=1.0), schur_method="dct",
                      dtype="float32", error_if_not_converged=False)
    rel = float(np.max(np.abs(x32 - x64)) / np.abs(x64).max())
    chk.bound(f"lattice {n}²: float32 DCT vs f64", rel, 1e-4, F32_HI)


def phase_web(chk: Checks, n: int = FULL["web"], expect_mf: bool = True) -> None:
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_random_network

    mesh = NetworkMesh(make_random_network(n, keep=0.7, seed=42, arrays=True), N=2,
                       color_strategy="fast")
    R = np.random.default_rng(1).uniform(0.5, 3.0, mesh.num_edges)
    asm = _assembler(mesh, R=R)
    engaged, stats = _mf_engaged(asm)
    if expect_mf:
        chk.true(f"web {n}: multifrontal engaged", engaged, f"core plan {stats}")
    _, _, x = solve(asm)
    chk.bound(f"web {n}: solve vs host LU", rel_err(x, superlu(asm)), 1e-10)


def phase_bed(chk: Checks, dims: tuple = FULL["bed"]) -> None:
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_vascular_bed

    mesh = NetworkMesh(make_vascular_bed(*dims, arrays=True), N=2, color_strategy="fast")
    asm = _assembler(mesh, R=1.0 / mesh.edge_radius**4)
    _, stats = _mf_engaged(asm)
    print(f"bed {dims}: {mesh.num_edges} vessels, core plan {stats}", flush=True)
    _, _, x = solve(asm)
    chk.bound(f"bed {dims}: solve vs host LU", rel_err(x, superlu(asm)), 1e-10)


def phase_mf_lattice(chk: Checks, n: int = FULL["mf_lattice"]) -> None:
    """Per-edge-R lattice just past the multifrontal threshold (core > 2048)."""
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_grid

    mesh = NetworkMesh(make_grid(n, n, arrays=True), N=1, color_strategy="fast")
    R = np.random.default_rng(n).uniform(0.5, 2.0, mesh.num_edges)
    asm = _assembler(mesh, R=R)
    engaged, stats = _mf_engaged(asm)
    chk.true(f"lattice {n}² per-edge R: multifrontal engaged", engaged, f"core plan {stats}")
    _, _, x = solve(asm)
    chk.bound(f"lattice {n}² per-edge R: solve vs host LU", rel_err(x, superlu(asm)), 1e-10)


def phase_engines(chk: Checks) -> None:
    for fn in (phase_lattice_dct, phase_lattice_f32, phase_web, phase_bed, phase_mf_lattice):
        t0 = time.perf_counter()
        fn(chk)
        print(f"engines: {fn.__name__} {time.perf_counter() - t0:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the correctness matrix (small networks, fixed sizes)
# ---------------------------------------------------------------------------


def _tree5():
    from networks_fenicsx_tpu import NetworkMesh, network_generation

    return NetworkMesh(network_generation.make_tree(5, 2, 3, arrays=True), N=2,
                       color_strategy="fast")


def _vec(sol) -> np.ndarray:
    return np.concatenate([np.ravel(f.values) for f in sol])


def check_y_analytic(chk: Checks) -> None:
    """1. Y-bifurcation λ = −1/(√2.5+1) through every method."""
    from networks_fenicsx_tpu import NetworkMesh, network_generation

    mesh = NetworkMesh(network_generation.make_tree(2, 1, 3, arrays=True), N=4)
    lam_exact = -1 / (np.sqrt(2.5) + 1)
    for method in ("schur", "dense", "minres", "host_lu"):
        _, sol, _ = solve(_assembler(mesh), method=method, rtol=1e-13)
        chk.bound(f"Y analytic [{method}]", abs(float(sol[-1].values[0]) - lam_exact), 1e-8)


def check_schur_submethods(chk: Checks) -> None:
    """2. schur sub-methods agree on a 5-generation tree."""
    mesh = _tree5()
    R = np.linspace(1, 3, mesh.num_edges)
    _, _, ref = solve(_assembler(mesh, R=R), schur_method="tree", rtol=1e-13)
    for sm in ("dense", "cg"):
        _, _, x = solve(_assembler(mesh, R=R), schur_method=sm, rtol=1e-13)
        chk.bound(f"tree5 schur [{sm}] vs tree", float(np.max(np.abs(x - ref))), 1e-8)


def check_cyclic_core(chk: Checks) -> None:
    """3. A small cyclic core vs host LU."""
    from networks_fenicsx_tpu import ArrayNetwork, NetworkMesh

    pos = np.array([(0, 0, 0), (0, 0, 1), (.2, .2, 2), (-.2, .3, 2), (0, .1, 2.1),
                    (.1, -.1, 3), (-.3, .4, 4), (0, 0, 1.1)], float)
    edges = np.array([(0, 1), (1, 7), (7, 2), (2, 5), (7, 3), (3, 4), (4, 5), (7, 4), (5, 6)])
    mesh = NetworkMesh(ArrayNetwork(pos=pos, edges=edges), N=3)
    p_bc = lambda x: x[2]  # noqa: E731
    _, _, x = solve(_assembler(mesh, p_bc=p_bc), method="schur", schur_method="tree")
    _, _, ref = solve(_assembler(mesh, p_bc=p_bc), method="host_lu")
    chk.bound("cyclic core vs host LU", float(np.max(np.abs(x - ref))), 1e-8)


def check_continuous_pressure(chk: Checks) -> None:
    """4. Continuous pressure (schur_p) vs host LU."""
    from networks_fenicsx_tpu import HydraulicNetworkAssembler

    mesh = _tree5()

    def asm():
        a = HydraulicNetworkAssembler(mesh, flux_degree=2, pressure_degree=1)
        a.compute_forms(p_bc_ex=lambda x: x[1])
        return a

    s, _, x = solve(asm(), method="schur_p", rtol=1e-12)
    _, _, ref = solve(asm(), method="host_lu")
    chk.bound(f"schur_p vs host LU ({s.info.iterations} iterations)",
              float(np.max(np.abs(x - ref))), 1e-7)


def check_degree3(chk: Checks) -> None:
    """5. Flux degree 3 condensation vs host LU."""
    from networks_fenicsx_tpu import HydraulicNetworkAssembler

    mesh = _tree5()

    def asm():
        a = HydraulicNetworkAssembler(mesh, flux_degree=3)
        a.compute_forms(p_bc_ex=lambda x: x[1])
        return a

    _, _, x = solve(asm())
    _, _, ref = solve(asm(), method="host_lu")
    chk.bound("k=3 condensation vs host LU", float(np.max(np.abs(x - ref))), 1e-8)


def check_sweep(chk: Checks) -> None:
    """6. Batched resistance sweep: flux scales as 1/R."""
    from networks_fenicsx_tpu import NetworkMesh, network_generation, solve_sweep

    mesh = NetworkMesh(network_generation.make_tree(2, 1, 3, arrays=True), N=4)
    asm = _assembler(mesh, R=np.ones(mesh.num_edges))
    scale = np.array([1.0, 2.0, 3.0, 4.0])
    res = solve_sweep(asm, R=np.ones((4, mesh.num_edges)) * scale[:, None])
    q0 = np.asarray(res.x[:, 0])
    chk.bound("sweep linearity", float(np.max(np.abs(q0 * scale - q0[0])) / abs(q0[0])), 1e-9)


def check_grid_vs_lu(chk: Checks) -> None:
    """7. Fully cyclic 5×4 lattice vs host LU."""
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_grid

    mesh = NetworkMesh(make_grid(5, 4, arrays=True), N=2, color_strategy="fast")
    p_bc = lambda x: x[0]  # noqa: E731
    _, _, x = solve(_assembler(mesh, p_bc=p_bc))
    _, _, ref = solve(_assembler(mesh, p_bc=p_bc), method="host_lu")
    chk.bound("grid 5x4 vs host LU", float(np.max(np.abs(x - ref))), 1e-8)


def check_float32_tree(chk: Checks) -> None:
    """8. float32 serving mode on a 5-generation tree."""
    mesh = _tree5()
    _, _, x32 = solve(_assembler(mesh), dtype="float32")
    _, _, x64 = solve(_assembler(mesh))
    rel = float(np.max(np.abs(x64 - x32)) / np.max(np.abs(x64)))
    chk.bound("tree5 float32 serving vs f64", rel, 1e-4, F32_HI)


def check_goldens(chk: Checks) -> None:
    """9. Committed exact-rational goldens."""
    from networks_fenicsx_tpu import NetworkMesh, network_generation

    for name in ("y_source", "arterial_poiseuille"):
        g = json.loads((REPO / "tests" / "goldens" / f"{name}.json").read_text())
        spec = g["config"]
        if spec["graph"] == "tree":
            G = network_generation.make_tree(spec["n"], spec["H"], spec["W"], arrays=True)
        else:
            G = network_generation.make_arterial_tree(
                N=spec["n"], direction=np.asarray(spec["direction"]), arrays=True)
        mesh = NetworkMesh(G, N=spec["N"])
        R = 1.0 / mesh.edge_radius**4 if spec.get("R") == "poiseuille" else spec.get("R")
        p_bc = (lambda x: x[0]) if spec["p_bc"] == "x" else (lambda x: x[1])
        _, sol, _ = solve(_assembler(mesh, p_bc=p_bc, R=R, f=spec.get("f")))
        lam = dict(zip(mesh.bifurcation_values.tolist(), sol[-1].values.tolist()))
        err = max(abs(lam[int(k)] - v) for k, v in g["lam"].items())
        chk.bound(f"golden [{name}] λ", err, 1e-10)


def check_tree_dist_single(chk: Checks) -> None:
    """10. Distributed λ elimination on one device."""
    from networks_fenicsx_tpu.parallel import ShardedNetworkSolver

    mesh = _tree5()
    sd = ShardedNetworkSolver(_assembler(mesh), devices=_one_device(),
                              schur_method="tree_dist")
    sd.assemble()
    x = _vec(sd.solve())
    _, _, ref = solve(_assembler(mesh))
    chk.true("tree_dist on one device: method", sd.info.method == "schur_sharded_dist",
             sd.info.method)
    chk.bound("tree_dist on one device vs Solver", float(np.max(np.abs(x - ref))), 1e-10)


def check_vtu_roundtrip(chk: Checks) -> None:
    """11. Binary VTU round trip of a device solution."""
    from networks_fenicsx_tpu.io.vtk import VTK_LINE, read_vtu, write_vtu

    mesh = _tree5()
    _, sol, _ = solve(_assembler(mesh))
    vals = np.asarray(sol[-2].values)
    with tempfile.TemporaryDirectory() as td:
        path = write_vtu(Path(td) / "p.vtu", mesh.vertices, mesh.cells, VTK_LINE,
                         cell_data={"p": vals}, fmt="binary")
        _, _, _, cd = read_vtu(path)
    chk.true("binary VTU round trip", np.array_equal(cd["p"], vals))


def check_uniform_vs_generic(chk: Checks) -> None:
    """12. Per-edge (uniform closed-form) path == per-cell (generic) path."""
    mesh = _tree5()
    R = np.linspace(1.0, 3.0, mesh.num_edges)
    _, _, x = solve(_assembler(mesh, R=R, f=1.7))
    _, _, ref = solve(_assembler(mesh, R=R[mesh.cell_edge], f=1.7))
    chk.bound("uniform vs generic path", float(np.max(np.abs(x - ref))), 1e-10)


def _blocked_vs(asm):
    """Run the blocked executor on ``asm``; returns (engaged, flat x)."""
    from networks_fenicsx_tpu import solver as S
    from networks_fenicsx_tpu.utils.config import SolverOptions

    ex = S.build_schur_executor(asm, SolverOptions(), outputs="blocks", internal_layout=True)
    if not isinstance(ex, S._BlockedExecutor):
        return False, None
    o = ex(*ex.prepare_args(*asm.schur_arguments(device=False)))
    x = S._flatten_blocks_host(o[0], o[1], o[2], asm.network.edge_color,
                               edge_order=ex.edge_order, bif_order=ex.bif_order)
    return True, x


def check_blocked_vs_general(chk: Checks) -> None:
    """13. Blocked-sibling executor == general level-plan executor."""
    from networks_fenicsx_tpu import solver as S
    from networks_fenicsx_tpu.utils.config import SolverOptions

    mesh = _tree5()
    asm = _assembler(mesh, p_bc=lambda x: x[0] + 0.5 * x[1],
                     R=np.linspace(0.5, 2.0, mesh.num_edges), f=0.9)
    engaged, xb = _blocked_vs(asm)
    exg = S.build_schur_executor(asm, SolverOptions(), outputs="blocks")
    og = exg(*asm.schur_arguments())
    xg = S._flatten_blocks_host(og[0], og[1], og[2], mesh.edge_color)
    chk.true("blocked executor engaged (tree5)", engaged)
    chk.bound("blocked vs general executor", float(np.max(np.abs(xb - xg))), 1e-11)


def check_kary_blocked(chk: Checks) -> None:
    """14. 3-ary blocked plan with per-cell coefficients vs host LU."""
    from networks_fenicsx_tpu import ArrayNetwork, NetworkMesh

    pos = [(0.0, -1.0, 0.0), (0.0, 0.0, 0.0)]
    edges = [(0, 1)]
    frontier = [(1, 0.0)]
    for d in range(2):
        nxt = []
        for node, x in frontier:
            for j in range(3):
                cx = x + (j - 1.0) * 3.0 ** (1 - d)
                pos.append((cx, float(d + 1), 0.0))
                edges.append((node, len(pos) - 1))
                nxt.append((len(pos) - 1, cx))
        frontier = nxt
    mesh = NetworkMesh(ArrayNetwork(pos=np.asarray(pos), edges=np.asarray(edges)), N=3)
    forms = dict(R=np.linspace(0.5, 2.0, mesh.num_cells), f=0.4)
    engaged, xk = _blocked_vs(_assembler(mesh, **forms))
    _, _, ref = solve(_assembler(mesh, **forms), method="host_lu")
    chk.true("3-ary blocked executor engaged", engaged)
    chk.bound("3-ary per-cell blocked vs host LU", float(np.max(np.abs(xk - ref))), 1e-9)


def check_sharded_blocked_single(chk: Checks) -> None:
    """15. Sharded blocked path on a one-device mesh."""
    from networks_fenicsx_tpu.parallel import ShardedNetworkSolver

    mesh = _tree5()
    R = np.linspace(1, 3, mesh.num_edges)
    ss = ShardedNetworkSolver(_assembler(mesh, R=R), devices=_one_device())
    ss.assemble()
    x = _vec(ss.solve())
    _, _, ref = solve(_assembler(mesh, R=R))
    chk.true("sharded blocked on one device: method",
             ss.info.method == "schur_sharded_blocked", ss.info.method)
    chk.bound("sharded blocked on one device vs Solver", float(np.max(np.abs(x - ref))), 1e-11)


def check_blocked_degree2(chk: Checks) -> None:
    """16. Blocked executor at flux degree 2 vs host LU."""
    from networks_fenicsx_tpu import HydraulicNetworkAssembler

    mesh = _tree5()

    def asm():
        a = HydraulicNetworkAssembler(mesh, flux_degree=2)
        a.compute_forms(p_bc_ex=lambda x: x[1], f=0.4, R=np.linspace(0.5, 2.0, mesh.num_edges))
        return a

    engaged, _ = _blocked_vs(asm())
    _, _, x = solve(asm())
    _, _, ref = solve(asm(), method="host_lu")
    chk.true("degree-2 blocked executor engaged", engaged)
    chk.bound("degree-2 blocked vs host LU", float(np.max(np.abs(x - ref))), 1e-9)


def check_lattice_dct_128(chk: Checks) -> None:
    """17. Lattice DCT transform precision at 128²."""
    phase_lattice_dct(chk, 128)


def _grid9x7():
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_grid

    return NetworkMesh(make_grid(9, 7, arrays=True), N=2, color_strategy="fast")


def check_sharded_grid_single(chk: Checks) -> None:
    """18. Strip-sharded lattice executor on a one-device mesh."""
    from networks_fenicsx_tpu.parallel import ShardedNetworkSolver

    mesh = _grid9x7()
    forms = dict(p_bc=lambda x: x[0], f=0.4, R=1.5)
    ss = ShardedNetworkSolver(_assembler(mesh, **forms), devices=_one_device())
    ss.assemble()
    x = _vec(ss.solve())
    _, _, ref = solve(_assembler(mesh, **forms), method="host_lu")
    chk.true("sharded grid on one device: method", ss.info.method == "schur_sharded_grid",
             ss.info.method)
    chk.bound("sharded grid on one device vs host LU", float(np.max(np.abs(x - ref))), 1e-10)


def check_factor_pairs(chk: Checks) -> None:
    """19. Factor/solve pairs vs the fused solvers (forest + lattice)."""
    from networks_fenicsx_tpu.solver import (
        build_blocked_factorization,
        build_grid_factorization,
    )

    def via_factor(build, asm):
        fac = build(asm)
        args = asm.schur_arguments(device=False)
        state = fac.factor(args[0])
        return fac.solution_vector(fac.solve(state, args[1], args[2], args[3]))

    mesh = _tree5()
    forms = dict(f=0.7, R=np.linspace(0.5, 2.0, mesh.num_edges))
    xf = via_factor(build_blocked_factorization, _assembler(mesh, **forms))
    _, _, ref = solve(_assembler(mesh, **forms))
    chk.bound("factor pair vs fused (forest)", rel_err(xf, ref), 1e-11)

    grid = _grid9x7()
    gforms = dict(p_bc=lambda x: x[0], f=0.4, R=1.5)
    xg = via_factor(build_grid_factorization, _assembler(grid, **gforms))
    _, _, refg = solve(_assembler(grid, **gforms), method="host_lu")
    chk.bound("factor pair vs host LU (lattice)", rel_err(xg, refg), 1e-10)


def check_level_scan(chk: Checks) -> None:
    """20b. Level-scan elimination == the unrolled program."""
    mesh = _tree5()
    forms = dict(f=0.4, R=np.linspace(0.5, 2.0, mesh.num_edges))
    _, _, x_sc = solve(_assembler(mesh, **forms), level_scan="on")
    _, _, x_un = solve(_assembler(mesh, **forms))
    chk.bound("level scan vs unrolled", rel_err(x_sc, x_un), 1e-12)


def check_unstructured_core(chk: Checks) -> None:
    """20. Sparse cycle-core elimination on an 800-junction web."""
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_random_network
    from networks_fenicsx_tpu.solver import _plan_tree_elimination, attach_core_plan

    mesh = NetworkMesh(make_random_network(800, keep=0.6, seed=17, arrays=True), N=2,
                       color_strategy="fast")
    forms = dict(p_bc=lambda x: x[0], f=0.3,
                 R=np.random.default_rng(2).uniform(0.5, 3.0, mesh.num_edges))
    asm = _assembler(mesh, **forms)
    plan = attach_core_plan(_plan_tree_elimination(asm))
    _, _, x = solve(asm)
    _, _, ref = solve(_assembler(mesh, **forms), method="host_lu")
    chk.true("web 800: sparse core plan", plan.core_plan is not None,
             str(plan.core_plan.stats if plan.core_plan else None))
    chk.bound("web 800 vs host LU", rel_err(x, ref), 1e-10)


def check_bed_small(chk: Checks) -> None:
    """27. Composite perfusion bed (4 generations, 32×20 lattice)."""
    phase_bed(chk, (4, 32, 20))


def _nd_lattice():
    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import make_grid
    from networks_fenicsx_tpu.ops.core_elim import nested_dissection_order
    from networks_fenicsx_tpu.solver import _plan_tree_elimination

    mesh = NetworkMesh(make_grid(40, 40, arrays=True), N=1, color_strategy="fast")
    R = np.random.default_rng(6).uniform(0.5, 2.0, mesh.num_edges)
    asm = _assembler(mesh, p_bc=lambda x: x[0], R=R)
    plan = _plan_tree_elimination(asm)
    order = nested_dissection_order(np.asarray(plan.core_pairs), plan.core_size, leaf=8)
    _, _, ref = solve(_assembler(mesh, p_bc=lambda x: x[0], R=R), method="host_lu")
    return asm, plan, order, ref


def _solve_with_core_plan(asm, plan, core_plan):
    from networks_fenicsx_tpu import SolverOptions
    from networks_fenicsx_tpu.solver import _schur_solve, build_schur_executor

    opts = SolverOptions(method="schur", schur_method="tree")
    ex = build_schur_executor(asm, opts, _tree_plan=plan._replace(core_plan=core_plan))
    x, info = _schur_solve(asm, opts, executor=ex)
    return np.asarray(x), info


def check_nested_dissection(chk: Checks) -> None:
    """28. Nested-dissection-ordered sparse core on a 40² lattice."""
    from networks_fenicsx_tpu.ops.core_elim import plan_core_elimination

    asm, plan, order, ref = _nd_lattice()
    cp = plan_core_elimination(np.asarray(plan.core_pairs), plan.core_size, dense_cutoff=64,
                               kcap=64, order=order, tail_stop=False)
    chk.true("ND core plan has rounds", cp is not None and cp.stats["rounds"] > 0,
             str(cp.stats if cp else None))
    x, _ = _solve_with_core_plan(asm, plan, cp)
    chk.bound("ND core vs host LU", rel_err(x, ref), 1e-10)


def check_supernodal_tail(chk: Checks) -> None:
    """29. Supernodal front tail, forced tiny fronts on the 40² lattice."""
    from networks_fenicsx_tpu.ops.core_elim import plan_core_elimination

    asm, plan, order, ref = _nd_lattice()
    cp = plan_core_elimination(np.asarray(plan.core_pairs), plan.core_size, dense_cutoff=64,
                               kcap=24, order=order, dense_cap=16, supernodal_tail=True,
                               front_max=37, tail_stop=False)
    if not chk.true("supernodal tail planned", cp is not None and bool(cp.fronts)):
        return
    x, info = _solve_with_core_plan(asm, plan, cp)
    chk.true("supernodal tail converged", info.converged,
             f"{len(cp.fronts)} fronts, max {cp.stats['front_max']}")
    chk.bound("supernodal tail vs host LU", rel_err(x, ref), 1e-10)


MATRIX = [
    check_y_analytic, check_schur_submethods, check_cyclic_core,
    check_continuous_pressure, check_degree3, check_sweep, check_grid_vs_lu,
    check_float32_tree, check_goldens, check_tree_dist_single, check_vtu_roundtrip,
    check_uniform_vs_generic, check_blocked_vs_general, check_kary_blocked,
    check_sharded_blocked_single, check_blocked_degree2, check_lattice_dct_128,
    check_sharded_grid_single, check_factor_pairs, check_level_scan,
    check_unstructured_core, check_bed_small, check_nested_dissection,
    check_supernodal_tail,
]


def _one_device():
    import jax

    return jax.devices()[:1]


def phase_matrix(chk: Checks) -> None:
    for check in MATRIX:
        check(chk)


# ---------------------------------------------------------------------------
# phase 5: card-only pytest tests, in this process
# ---------------------------------------------------------------------------


class _Tally:
    """pytest plugin counting outcomes of the test calls."""

    def __init__(self) -> None:
        self.outcomes: dict[str, int] = {}

    def pytest_runtest_logreport(self, report) -> None:
        if report.when == "call" or report.outcome != "passed":
            self.outcomes[report.outcome] = self.outcomes.get(report.outcome, 0) + 1


def phase_pytest(chk: Checks) -> None:
    import pytest

    os.environ["NXFX_TESTS_ON_DEVICE"] = "1"  # conftest keeps the GPU backend
    tally = _Tally()
    rc = pytest.main([str(REPO / "tests" / "test_gpu.py"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider"], plugins=[tally])
    passed = tally.outcomes.get("passed", 0)
    chk.true("card-only pytest tests", rc == 0 and passed > 0
             and passed == sum(tally.outcomes.values()), f"rc={rc} {tally.outcomes}")


# ---------------------------------------------------------------------------
# --multi: the sharded paths on four cards, each vs the one-card Solver
# ---------------------------------------------------------------------------


def _spread(chk: Checks, label: str, n: int, device_io) -> None:
    """Pass when the sharded program's inputs and outputs each have shards
    on ``n`` distinct devices."""
    import jax

    def ids(tree) -> list[int]:
        return sorted({s.device.id for leaf in jax.tree_util.tree_leaves(tree)
                       if isinstance(leaf, jax.Array) for s in leaf.addressable_shards})

    ins, outs = ids(device_io[0]), ids(device_io[1])
    chk.true(f"{label}: shards on {n} devices", len(ins) == n and len(outs) == n,
             f"inputs on {ins}, outputs on {outs}")


def _sharded(asm, devices, **kw):
    from networks_fenicsx_tpu.parallel import ShardedNetworkSolver

    ss = ShardedNetworkSolver(asm, devices=devices, **kw)
    ss.assemble()
    return ss, _vec(ss.solve())


def phase_multi(chk: Checks, n_dev: int = 4, gens: int = FULL["gens"], N: int = FULL["N"],
                lattice: int = FULL["lattice"], web: int = FULL["web"]) -> None:
    import jax

    from networks_fenicsx_tpu import NetworkMesh
    from networks_fenicsx_tpu.network_generation import (
        make_arterial_tree,
        make_grid,
        make_random_network,
    )
    from networks_fenicsx_tpu.parallel.sweep import sharded_sweep

    devs = jax.devices()[:n_dev]
    tree = NetworkMesh(make_arterial_tree(gens, direction=np.array([0.1, 1.0, 0.0]),
                                          arrays=True), N=N, color_strategy="fast")
    R = 1.0 / tree.edge_radius**4
    _, _, ref = solve(_assembler(tree, R=R))
    print(f"multi: tree {gens} generations, {tree.num_edges} vessels", flush=True)

    ss, x = _sharded(_assembler(tree, R=R), devs)
    chk.true("multi tree: method", ss.info.method == "schur_sharded_blocked", ss.info.method)
    _spread(chk, "multi tree", n_dev, ss.device_io)
    chk.bound("multi tree: sharded blocked vs one-card Solver", rel_err(x, ref), 1e-11)

    ss, x = _sharded(_assembler(tree, R=R), devs, schur_method="tree_dist")
    chk.true("multi tree_dist: method", ss.info.method == "schur_sharded_dist", ss.info.method)
    _spread(chk, "multi tree_dist", n_dev, ss.device_io)
    chk.bound("multi tree_dist vs one-card Solver", rel_err(x, ref), 1e-10)

    scale = np.array([1.0, 2.0])
    res = sharded_sweep(_assembler(tree, R=R), R[None, :] * scale[:, None], devices=devs,
                        mesh_shape=(2, n_dev // 2))
    _spread(chk, "multi sweep (2, 2)", n_dev, res.device_io)
    for i, c in enumerate(scale):
        _, _, ref_i = solve(_assembler(tree, R=R * c))
        chk.bound(f"multi sweep scenario {i} vs one-card Solver",
                  rel_err(np.asarray(res.x[i]), ref_i), 1e-10)

    grid = NetworkMesh(make_grid(lattice, lattice, arrays=True), N=1, color_strategy="fast")
    _, _, ref = solve(_assembler(grid, R=1.0), schur_method="dct")
    ss, x = _sharded(_assembler(grid, R=1.0), devs)
    chk.true("multi lattice: method", ss.info.method == "schur_sharded_grid", ss.info.method)
    _spread(chk, f"multi lattice {lattice}²", n_dev, ss.device_io)
    # Both are exact f64 solves; they differ by O(κ·ε) in summation order,
    # and κ of the λ system grows as n² (≈1e5 at 512²).  The one-card
    # solve itself sits 8.5e-13 / 2.7e-12 / 1.2e-11 from SuperLU at
    # 64² / 128² / 256² (CPU), ×4 per doubling, so ~5e-11 at 512².
    chk.bound(f"multi lattice {lattice}² vs one-card Solver", rel_err(x, ref), 1e-9)

    wmesh = NetworkMesh(make_random_network(web, keep=0.7, seed=42, arrays=True), N=2,
                        color_strategy="fast")
    Rw = np.random.default_rng(1).uniform(0.5, 3.0, wmesh.num_edges)
    t0 = time.perf_counter()
    _, _, ref = solve(_assembler(wmesh, R=Rw))
    print(f"multi web {web}: one-card Solver {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    ss, x = _sharded(_assembler(wmesh, R=Rw), devs)
    print(f"multi web {web}: sharded first solve {time.perf_counter() - t0:.1f}s", flush=True)
    chk.true("multi web: general pipeline", ss.info.method == "schur_sharded", ss.info.method)
    _spread(chk, f"multi web {web}", n_dev, ss.device_io)
    chk.bound(f"multi web {web} vs one-card Solver", rel_err(x, ref), 1e-9)


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1
    t_start = time.perf_counter()

    device = phase_device(n_cards)
    from networks_fenicsx_tpu.utils.platform import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    chk = Checks()
    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [("main", phase_main), ("engines", phase_engines),
                  ("matrix", phase_matrix), ("pytest", phase_pytest)]
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        try:
            fn(chk)
        except Exception:  # a phase that raises fails, and the next still runs
            traceback.print_exc()
            chk.failed.append(f"phase {name} raised")
        print(f"== phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)

    print("nvidia-smi --query-gpu=name,power.limit:", flush=True)
    for line in device.pop("cards"):
        print(line, flush=True)
    print(f"{chk.count} checks, {len(chk.failed)} failed, "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    if chk.failed:
        print("FAILED: " + "; ".join(chk.failed), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
