"""Per-op device profile of the blocked executor programs (run on the GPU).

Measures the 16-generation arterial (N=40) and n=20 tree (N=1) blocked
programs with ``jax.profiler.trace`` and aggregates device-event
durations by op name: how much of the device program is per-level launch
overhead vs the big solution-block writes.

Usage:  python scripts/profile_blocked.py [16gen|n20|both]
"""

import gzip
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def build(case: str):
    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        SolverOptions,
    )
    from networks_fenicsx_tpu.network_generation import make_arterial_tree, make_tree
    from networks_fenicsx_tpu.solver import build_schur_executor

    internal = True
    opts = SolverOptions()
    if case.startswith("16gen"):
        # "16gen_scan" profiles the lax.scan shallow-level variant
        # (SolverOptions.level_scan) against the default unrolled program.
        if case.endswith("_scan"):
            opts = SolverOptions(level_scan="on")
        elif case.endswith("_mixed"):
            # f64 solve, f32 solution blocks: halves output bytes and
            # skips the X64 recombination on the output writes.
            opts = SolverOptions(output_dtype="float32")
        G = make_arterial_tree(N=16, direction=np.array([0.1, 1.0, 0.0]))
        mesh = NetworkMesh(G, N=40, color_strategy="fast")
        asm = HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mesh.edge_radius**4)
    elif case.startswith("grid"):
        # 512² capillary lattice: general dct path vs gather-free grid layout
        from networks_fenicsx_tpu.network_generation import make_grid

        G = make_grid(512, 512, arrays=True)
        mesh = NetworkMesh(G, N=1, color_strategy="fast")
        asm = HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=lambda x: x[0], R=1.0)
        internal = case == "grid_blocked"
    else:  # n20
        G = make_tree(20, 1.0, 2.0, arrays=True)
        mesh = NetworkMesh(G, N=1, color_strategy="fast")
        asm = HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=lambda x: x[1])
    ex = build_schur_executor(
        asm, opts, outputs="blocks", internal_layout=internal
    )
    if not hasattr(ex, "prepare_args"):
        class _Plain:
            def __init__(self, fn):
                self._fn = fn

            def __call__(self, *a):
                return self._fn(*a)

            def prepare_args(self, *a):
                return a

        ex = _Plain(ex)
    args = ex.prepare_args(*asm.schur_arguments(device=False))
    import jax

    args = jax.device_put(args)
    return ex, args


def profile(case: str, outdir: Path, reps: int = 30):
    import jax
    import jax.numpy as jnp

    if case.startswith("batched"):
        ex, args = build("16gen")
        S = 8
        args = tuple(
            jnp.asarray(np.broadcast_to(np.asarray(a), (S,) + np.asarray(a).shape).copy())
            for a in args
        )
        fn = jax.jit(jax.vmap(ex._fn))

        class _Ex:
            def __call__(self, *a):
                return fn(*a)

        ex = _Ex()
        reps = max(4, reps // 8)
    else:
        ex, args = build(case)
    # warm up (compile)
    out = ex(*args)
    np.asarray(out[0][:1, :1])
    trace_dir = outdir / f"trace_{case}"
    with jax.profiler.trace(str(trace_dir)):
        for _ in range(reps):
            out = ex(*args)
        np.asarray(out[0][:1, :1])
    # aggregate device events from the trace
    traces = sorted(trace_dir.glob("**/*.trace.json.gz"))
    assert traces, f"no trace under {trace_dir}"
    events = defaultdict(float)
    total = 0.0
    data = json.loads(gzip.open(traces[-1], "rt").read())
    # device lanes: trace processes named "/device:..." (host threads are
    # "/host:...")
    pid_names = {
        p.get("pid"): p.get("args", {}).get("name", "")
        for p in data["traceEvents"]
        if p.get("ph") == "M" and p.get("name") == "process_name"
    }
    for ev in data["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        pname = pid_names.get(ev.get("pid"), "")
        if "/device:" not in pname:
            continue
        name = ev.get("name", "")
        dur = float(ev.get("dur", 0.0))  # microseconds
        events[name] += dur
        total += dur
    rows = sorted(events.items(), key=lambda kv: -kv[1])
    print(f"\n=== {case}: device op totals over {reps} dispatches ===")
    print(f"{'us/solve':>10}  op")
    shown = 0.0
    for name, dur in rows[:25]:
        print(f"{dur / reps:10.1f}  {name[:110]}")
        shown += dur
    print(f"total device time: {total / reps / 1e3:.3f} ms/solve "
          f"(top-25 covers {100 * shown / max(total, 1e-9):.0f}%)")
    return total / reps / 1e3


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    outdir = Path("/tmp/nxfx_profile")
    outdir.mkdir(parents=True, exist_ok=True)
    from networks_fenicsx_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()
    if which in ("16gen", "both"):
        profile("16gen", outdir)
    if which in ("n20", "both"):
        profile("n20", outdir)
    if which == "batched16":
        profile("batched16", outdir)
    if which in ("16gen_scan", "scan"):
        profile("16gen", outdir)
        profile("16gen_scan", outdir)
    if which in ("16gen_mixed", "mixed"):
        profile("16gen_mixed", outdir)
    if which in ("grid", "grid_general"):
        profile("grid_general", outdir)
    if which in ("grid", "grid_blocked"):
        profile("grid_blocked", outdir)
