"""Headline benchmark: arterial-tree assemble+solve throughput.

BASELINE.md target: arterial-tree assemble+solve wall-clock vs. MPI
DOLFINx+MUMPS at >= 10 tree generations, DOFs/sec as the headline metric.
The default configuration is 16 generations (65,535 vessels, 5.34M dofs);
set NXFX_BENCH_GENS=10 for the minimal BASELINE configuration.  DOLFINx is
not installed in this image, so the recorded ``vs_baseline`` compares the
device Schur pipeline against the strongest available stand-in for the
reference's direct solver: SciPy SuperLU factorise+solve of the identical
assembled sparse system on the host CPU (the same role MUMPS plays for the
reference, reference ``solver.py:58-65``).

The benchmark needs a GPU: with any other JAX backend it prints a failure
record and exits non-zero.  Everything runs in this one process (a second
process would not get the card's memory).  The record names the device
(platform, ``device_kind``, count) and the card's name and power limit.

Output contract (readers keep only the tail of stdout):

  * the FULL record is written to ``BENCH_DETAIL.json`` and also printed
    as an earlier ``BENCH_DETAIL {...}`` line;
  * the FINAL stdout line is a compact, size-checked headline JSON
    (< 1,800 chars) with the usual
    ``{"metric": ..., "value": dofs_per_sec, "unit": "dofs/s",
    "vs_baseline": speedup}`` keys plus one-number per-stage summaries.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _emit_failure(cause: str) -> None:
    """Emit ONE parseable JSON line naming the failure cause, so a failed
    run still leaves a machine-readable record."""
    print(
        json.dumps(
            {
                "metric": "arterial_tree_assemble_solve_dofs_per_sec",
                "value": None,
                "unit": "dofs/s",
                "vs_baseline": None,
                "error": cause,
            }
        ),
        flush=True,
    )


def _compact_headline(result: dict) -> dict:
    """Build the final-stdout-line record, guaranteed < ~1,800 chars.

    One-number per-stage summaries only; the full detail block lives in
    ``BENCH_DETAIL.json``.  Size-checked with two fallback levels so the
    final line never outgrows a 2,000-char tail window.
    """
    d = result.get("detail", {})

    def stage(name: str, *keys: str) -> dict | None:
        s = d.get(name)
        if not isinstance(s, dict):
            return None
        out = {k: s[k] for k in keys if s.get(k) is not None}
        if s.get("error"):
            out["error"] = str(s["error"])[:80]
        return out or None

    dev = d.get("device") or {}
    head = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "headline": {
            "generations": d.get("generations"),
            "num_dofs": d.get("num_dofs"),
            "assemble_solve_ms": d.get("assemble_solve_ms"),
            "pipelined_ms": d.get("pipelined_deep_ms_per_solve"),
            "f32_ms": d.get("pipelined_f32_ms_per_solve"),
            "mixed_ms": d.get("pipelined_mixed_out_f32_ms_per_solve"),
            "factor_reuse_ms": d.get("pipelined_factor_reuse_ms_per_solve"),
            "superlu_ms": d.get("baseline_superlu_ms_median"),
            "max_rel_err_vs_direct": d.get("max_rel_err_vs_direct"),
        },
        "device": {k: dev.get(k) for k in ("platform", "kind", "count", "card")},
        "stages": {
            "xl": stage("xl", "num_dofs", "assemble_solve_ms",
                        "pipelined_ms_per_solve"),
            "lattice": stage("lattice", "grid", "pipelined_ms_per_solve"),
            "unstructured": stage(
                "unstructured", "vs_superlu", "pipelined_ms_per_solve",
                "factor_reuse_ms_per_solve", "steady_state_ms_per_solve",
            ),
            "bed": stage("bed", "vs_superlu", "pipelined_ms_per_solve"),
            "supernodal": stage(
                "supernodal", "vs_superlu", "pipelined_ms_per_solve",
                "factor_reuse_ms_per_solve", "warm_compile_s",
            ),
        },
        "detail_file": "BENCH_DETAIL.json",
    }
    if "error" in result:
        head["error"] = str(result["error"])[:200]
    if len(json.dumps(head)) > 1800:
        head.pop("stages", None)
    if len(json.dumps(head)) > 1800:
        head = {k: result.get(k) for k in ("metric", "value", "unit", "vs_baseline")}
        head["detail_file"] = "BENCH_DETAIL.json"
    return head


def device_record() -> dict:
    """The device this run measures: JAX's view plus the card's name and
    power limit from ``nvidia-smi``.  Raises unless JAX's backend is a GPU."""
    from networks_fenicsx_tpu.utils.platform import gpu_device_record

    rec = gpu_device_record()
    return {**{k: rec[k] for k in ("platform", "kind", "count")}, "card": rec["cards"][0]}


def device_bytes_limit() -> int:
    """Bytes of device memory this process may allocate."""
    import jax

    return int(jax.devices()[0].memory_stats()["bytes_limit"])


def _emit_record(result: dict) -> None:
    """Write the full record to ``BENCH_DETAIL.json`` + an earlier stdout
    line, then print the compact headline as the FINAL stdout line."""
    detail_path = Path(__file__).resolve().parent / "BENCH_DETAIL.json"
    try:
        detail_path.write_text(json.dumps(result, indent=1) + "\n")
        log(f"full record written to {detail_path}")
    except OSError as e:  # pragma: no cover - read-only checkout
        log(f"could not write BENCH_DETAIL.json: {e!r}")
    print("BENCH_DETAIL " + json.dumps(result), flush=True)
    print(json.dumps(_compact_headline(result)), flush=True)


def main(device: dict) -> None:
    import jax

    from networks_fenicsx_tpu import (
        HydraulicNetworkAssembler,
        NetworkMesh,
        SolverOptions,
    )
    from networks_fenicsx_tpu.network_generation import make_arterial_tree
    import jax.numpy as jnp

    from networks_fenicsx_tpu.solver import build_schur_executor

    GENS = int(os.environ.get("NXFX_BENCH_GENS", "16"))
    N_ELEM = int(os.environ.get("NXFX_BENCH_N", "40"))

    # Soft deadline: the headline JSON must reach stdout before any
    # external watchdog kills the process — optional stages are skipped
    # once the budget runs short (each logs that it was).
    t_main0 = time.perf_counter()
    deadline_s = float(os.environ.get("NXFX_BENCH_DEADLINE", "2400"))

    def time_left() -> float:
        return deadline_s - (time.perf_counter() - t_main0)

    def stage_ok(name: str, need_s: float) -> bool:
        if time_left() > need_s:
            return True
        log(f"{name} stage skipped: {time_left():.0f}s left < {need_s:.0f}s "
            f"budget (NXFX_BENCH_DEADLINE={deadline_s:.0f})")
        return False

    # Persistent XLA compilation cache (the FFCx-cache analog): a warm
    # process start loads the serialized executable instead of recompiling.
    from networks_fenicsx_tpu.utils.platform import enable_compilation_cache

    log(f"persistent XLA cache: {enable_compilation_cache()}")
    log(f"device: {device}")

    t0 = time.perf_counter()
    G = make_arterial_tree(N=GENS, direction=np.array([0.1, 1.0, 0.0]), arrays=True)
    mesh = NetworkMesh(G, N=N_ELEM, color_strategy="fast")
    log(f"mesh: {mesh.num_edges} vessels, {mesh.num_cells} cells "
        f"({time.perf_counter() - t0:.2f}s build)")

    asm = HydraulicNetworkAssembler(mesh, flux_degree=1, pressure_degree=0)
    R = 1.0 / mesh.edge_radius**4
    p_bc = lambda x: x[1]  # noqa: E731
    asm.compute_forms(p_bc_ex=p_bc, R=R)
    n_dofs = asm.num_dofs
    log(f"dofs: {n_dofs} (flux+pressure+multipliers)")

    opts = SolverOptions()
    # j-major block outputs + blocked-sibling internal layout: the serving
    # contract (no device relayout/concat building the monolithic
    # PETSc-style vector).
    executor = build_schur_executor(
        asm, opts, outputs="blocks", internal_layout=True
    )
    prepare = getattr(executor, "prepare_args", None)
    log(f"blocked layout: {'on' if prepare is not None else 'off'}")

    def assemble_and_solve(verbose: bool = False):
        t0 = time.perf_counter()
        asm.compute_forms(p_bc_ex=p_bc, R=R)
        a = asm.schur_arguments(device=prepare is None)
        if prepare is not None:
            a = prepare(*a)
        t1 = time.perf_counter()
        out = executor(*a)
        jax.block_until_ready(out)
        if verbose:
            t2 = time.perf_counter()
            log(f"  [forms {1e3 * (t1 - t0):.1f} ms, exec {1e3 * (t2 - t1):.1f} ms]")
        return out

    # warmup: XLA trace + compile (or persistent-cache load) + first solve
    t0 = time.perf_counter()
    out = assemble_and_solve()
    from networks_fenicsx_tpu.solver import _flatten_blocks_host

    x = _flatten_blocks_host(
        out[0], out[1], out[2], mesh.edge_color,
        edge_order=getattr(executor, "edge_order", None),
        bif_order=getattr(executor, "bif_order", None),
    )
    t_warmup = time.perf_counter() - t0
    log(f"warmup (XLA compile or cache load + first solve): {t_warmup:.3f}s")
    assert np.all(np.isfinite(x)), "non-finite solution"

    # steady-state assemble+solve (forms recomputed per rep), best of
    # several reps.
    reps = int(os.environ.get("NXFX_BENCH_REPS", "5"))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        assemble_and_solve(verbose=True)
        times.append(time.perf_counter() - t0)
    t_solve = min(times)
    dofs_per_sec = n_dofs / t_solve
    log(f"assemble+solve: best {t_solve * 1e3:.2f} ms over {reps} reps "
        f"-> {dofs_per_sec:.3e} dofs/s")

    # Pipelined serving throughput: dispatch K solves back-to-back and
    # synchronize once — the steady-state rate a serving loop gets
    # (dispatches overlap the previous solve's execution).  Coefficients
    # live on device in a serving loop (they are the model state).
    args = asm.schur_arguments(device=prepare is None)
    if prepare is not None:
        args = prepare(*args)
    args = jax.device_put(args)
    jax.block_until_ready(args)
    K = int(os.environ.get("NXFX_BENCH_PIPELINE", "16"))
    K_deep = int(os.environ.get("NXFX_BENCH_PIPELINE_DEEP", "64"))
    # Cap outstanding solves so queued f64 output blocks (flux + pressure
    # per edge) fit in device memory: 3/8 of what this process may
    # allocate, leaving room for inputs, the working set and XLA scratch.
    mem_budget = 0.375 * device_bytes_limit()

    def hbm_fit(n_edges: int) -> int:
        out_bytes = (2 * N_ELEM + 1) * n_edges * 8
        return max(1, int(mem_budget / max(out_bytes, 1)))

    fit = hbm_fit(mesh.num_edges)
    if fit < K or fit < K_deep:
        K = min(K, fit)
        K_deep = min(K_deep, fit)
        log(f"pipeline depth capped at {fit} to fit queued outputs in HBM")

    def pipelined(depth: int) -> float:
        # best of several rounds (the first also absorbs residual warmup)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            outs = [executor(*args) for _ in range(depth)]
            np.asarray(outs[-1][0][:1, :1])  # one sync for the whole batch
            best = min(best, (time.perf_counter() - t0) / depth)
        return best

    t_pipe = pipelined(K)
    t_pipe_deep = pipelined(K_deep)
    log(f"pipelined x{K_deep}: {t_pipe_deep * 1e3:.2f} ms/solve "
        f"-> {n_dofs / t_pipe_deep:.3e} dofs/s")
    pipe_dofs_per_sec = n_dofs / t_pipe
    log(f"pipelined x{K}: {t_pipe * 1e3:.2f} ms/solve "
        f"-> {pipe_dofs_per_sec:.3e} dofs/s steady-state")

    # --- baseline: host sparse direct LU (SuperLU, MUMPS stand-in) on the
    # identical assembled system.
    import scipy.sparse.linalg as spla

    # Host-side COO of the identical system (same index/value arrays the
    # device assembly uses), so the baseline timing is pure SuperLU.
    As, bh = asm.host_system()
    # SuperLU is a *stand-in* for the reference's MUMPS (dolfinx is not
    # installable in this image) and its wall-clock swings with host load —
    # report the median over several repetitions plus the spread so the
    # speedup is read with the right error bars.
    base_reps = int(os.environ.get("NXFX_BENCH_BASELINE_REPS", "3"))
    base_times = []
    err = None
    try:
        for _ in range(base_reps):
            t0 = time.perf_counter()
            lu = spla.splu(As)
            x_lu = lu.solve(bh)
            base_times.append(time.perf_counter() - t0)
        t_baseline = float(np.median(base_times))
        log(
            f"baseline SuperLU (MUMPS stand-in) factor+solve: median "
            f"{t_baseline * 1e3:.2f} ms over {base_reps} reps "
            f"(min {min(base_times) * 1e3:.2f}, max {max(base_times) * 1e3:.2f})"
        )
        # correctness cross-check vs the direct solve (BASELINE: 1e-8)
        err = float(np.max(np.abs(x - x_lu)) / max(1.0, np.max(np.abs(x_lu))))
        log(f"max relative deviation schur vs direct LU: {err:.3e}")
        assert err < 1e-8, f"solution mismatch vs direct solver: {err}"
    except MemoryError:
        # At XL sizes the host direct solver cannot even hold the
        # factorisation (observed at 21.4M dofs) — report that honestly
        # rather than taking down the headline JSON.
        t_baseline = None
        log("baseline SuperLU: MemoryError — the host direct solver "
            "cannot factor this system in available RAM")

    # Batched serving: S independent coefficient scenarios per vmapped
    # dispatch, pipelined to the same total solve count as the deep
    # pipeline.
    S = int(os.environ.get("NXFX_BENCH_BATCH", "8"))
    best_b = None
    if prepare is not None and S > 1:
        # Optional diagnostics — never let them take down the headline run.
        try:
            batched = jax.jit(jax.vmap(getattr(executor, "_fn", executor)))
            bargs = tuple(
                jnp.asarray(jnp.broadcast_to(a, (S,) + a.shape)) for a in args
            )
            depth_b = max(1, K_deep // S)
            out_b = batched(*bargs)
            np.asarray(out_b[0][:1, :1, :1])  # warm + sync
            best_b = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs_b = [batched(*bargs) for _ in range(depth_b)]
                np.asarray(outs_b[-1][0][:1, :1, :1])
                best_b = min(best_b, (time.perf_counter() - t0) / (S * depth_b))
            log(f"batched x{S} (vmap, pipeline depth {depth_b}): "
                f"{best_b * 1e3:.2f} ms/solve -> {n_dofs / best_b:.3e} dofs/s")
            del batched, bargs, out_b, outs_b  # release queued HBM
        except Exception as e:  # pragma: no cover - defensive
            log(f"batched serving stage skipped: {e!r}")
            best_b = None

    # float32 serving mode: the same fused blocked program in single
    # precision — half the memory traffic (accuracy ~1e-5 relative; the
    # f64 path remains the default contract).  Skippable via
    # NXFX_BENCH_F32=0.
    t_pipe_f32 = None
    if (os.environ.get("NXFX_BENCH_F32", "1") != "0" and prepare is not None
            and stage_ok("float32 serving", 120)):
        try:
            ex32 = build_schur_executor(
                asm, SolverOptions(dtype="float32"), outputs="blocks",
                internal_layout=True,
            )
            args32 = jax.device_put(ex32.prepare_args(*asm.schur_arguments(device=False)))
            out32 = ex32(*args32)
            np.asarray(out32[0][:1, :1])  # warm + sync
            best32 = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs32 = [ex32(*args32) for _ in range(K_deep)]
                np.asarray(outs32[-1][0][:1, :1])
                best32 = min(best32, (time.perf_counter() - t0) / K_deep)
            t_pipe_f32 = best32
            log(f"pipelined x{K_deep} float32 serving: {t_pipe_f32 * 1e3:.2f} ms/solve "
                f"-> {n_dofs / t_pipe_f32:.3e} dofs/s")
            del ex32, args32, out32, outs32  # release queued HBM
        except Exception as e:  # pragma: no cover - defensive
            log(f"float32 serving stage skipped: {e!r}")
            t_pipe_f32 = None

    # Mixed serving contract: full-f64 solve, f32 output blocks
    # (SolverOptions.output_dtype) — values carry f64-solve accuracy
    # rounded once on output, halving output bytes.  NXFX_BENCH_MIXED=0
    # to skip.
    t_pipe_mixed = None
    if (os.environ.get("NXFX_BENCH_MIXED", "1") != "0" and prepare is not None
            and stage_ok("mixed serving", 120)):
        try:
            exm = build_schur_executor(
                asm, SolverOptions(output_dtype="float32"), outputs="blocks",
                internal_layout=True,
            )
            argsm = jax.device_put(exm.prepare_args(*asm.schur_arguments(device=False)))
            outm = exm(*argsm)
            np.asarray(outm[0][:1, :1])  # warm + sync
            bestm = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outsm = [exm(*argsm) for _ in range(K_deep)]
                np.asarray(outsm[-1][0][:1, :1])
                bestm = min(bestm, (time.perf_counter() - t0) / K_deep)
            t_pipe_mixed = bestm
            log(f"pipelined x{K_deep} mixed (f64 solve, f32 out): "
                f"{t_pipe_mixed * 1e3:.2f} ms/solve "
                f"-> {n_dofs / t_pipe_mixed:.3e} dofs/s")
            del exm, argsm, outm, outsm  # release queued HBM
        except Exception as e:  # pragma: no cover - defensive
            log(f"mixed serving stage skipped: {e!r}")
            t_pipe_mixed = None

    # --- level-scan serving variant: the shallow λ-elimination levels as
    # lax.scan loops instead of unrolled per-level kernels (the
    # launch-bound tail experiment — SolverOptions.level_scan).  Measured
    # side by side with the default program; NXFX_BENCH_LEVEL_SCAN=0 skips.
    t_pipe_scan = None
    if (os.environ.get("NXFX_BENCH_LEVEL_SCAN", "1") != "0" and prepare is not None
            and stage_ok("level-scan", 150)):
        try:
            exs = build_schur_executor(
                asm, SolverOptions(level_scan="on"), outputs="blocks",
                internal_layout=True,
            )
            argss = jax.device_put(exs.prepare_args(*asm.schur_arguments(device=False)))
            outs0 = exs(*argss)
            np.asarray(outs0[0][:1, :1])  # warm + sync
            bests = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outss = [exs(*argss) for _ in range(K_deep)]
                np.asarray(outss[-1][0][:1, :1])
                bests = min(bests, (time.perf_counter() - t0) / K_deep)
            t_pipe_scan = bests
            log(f"pipelined x{K_deep} level-scan variant: "
                f"{t_pipe_scan * 1e3:.2f} ms/solve "
                f"-> {n_dofs / t_pipe_scan:.3e} dofs/s")
            del exs, argss, outs0, outss  # release queued HBM
        except Exception as e:  # pragma: no cover - defensive
            log(f"level-scan stage skipped: {e!r}")
            t_pipe_scan = None

    # --- factor-reuse serving: the KSP/MUMPS factor-reuse analog.  One
    # resistance-side factorization, rhs-only solves pipelined — measures
    # the device-program delta of skipping condensation + d-elimination.
    # Failure-isolated; NXFX_BENCH_FACTOR=0 skips.
    t_pipe_factor = None
    if (os.environ.get("NXFX_BENCH_FACTOR", "1") != "0" and prepare is not None
            and stage_ok("factor-reuse", 150)):
        try:
            from networks_fenicsx_tpu.solver import build_blocked_factorization

            fac = build_blocked_factorization(asm, opts)
            R_arg, f_arg, sp_arg, ep_arg = asm.schur_arguments(device=False)
            state = jax.block_until_ready(fac.factor(R_arg))
            rhs = jax.device_put(fac.prepare_rhs(f_arg, sp_arg, ep_arg))
            outf = fac.solve_prepared(state, rhs)
            np.asarray(outf[0][:1, :1])  # warm + sync
            bestf = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outsf = [
                    fac.solve_prepared(state, rhs) for _ in range(K_deep)
                ]
                np.asarray(outsf[-1][0][:1, :1])
                bestf = min(bestf, (time.perf_counter() - t0) / K_deep)
            t_pipe_factor = bestf
            log(f"pipelined x{K_deep} factor-reuse (rhs-only solve): "
                f"{t_pipe_factor * 1e3:.2f} ms/solve "
                f"-> {n_dofs / t_pipe_factor:.3e} dofs/s")
            del fac, state, rhs, outf, outsf  # release queued HBM
        except Exception as e:  # pragma: no cover - defensive
            log(f"factor-reuse stage skipped: {e!r}")
            t_pipe_factor = None

    # --- XL scale point: one larger arterial tree (default 18 gen,
    # 262,143 vessels, 21.4M dofs) showing throughput past the dispatch
    # floor.  No host-LU baseline here (SuperLU ran out of host memory at
    # this size).  Failure-isolated; NXFX_BENCH_XL=0 skips.
    xl = None
    GENS_XL = int(os.environ.get("NXFX_BENCH_XL_GENS", "18"))
    if (os.environ.get("NXFX_BENCH_XL", "1") != "0" and GENS < GENS_XL
            and stage_ok("XL", 480)):
        try:
            t0 = time.perf_counter()
            G_x = make_arterial_tree(
                N=GENS_XL, direction=np.array([0.1, 1.0, 0.0]), arrays=True
            )
            mesh_x = NetworkMesh(G_x, N=N_ELEM, color_strategy="fast")
            asm_x = HydraulicNetworkAssembler(mesh_x, flux_degree=1, pressure_degree=0)
            R_x = 1.0 / mesh_x.edge_radius**4
            asm_x.compute_forms(p_bc_ex=p_bc, R=R_x)
            ex_x = build_schur_executor(
                asm_x, opts, outputs="blocks", internal_layout=True
            )
            log(f"XL: {GENS_XL} gen, {mesh_x.num_edges} vessels, "
                f"{asm_x.num_dofs} dofs ({time.perf_counter() - t0:.1f}s build)")
            out_x = ex_x(*jax.device_put(
                ex_x.prepare_args(*asm_x.schur_arguments(device=False))
            ))
            np.asarray(out_x[0][:1, :1])  # warm (compile) + sync
            xl_times = []
            for _ in range(3):
                t0 = time.perf_counter()
                asm_x.compute_forms(p_bc_ex=p_bc, R=R_x)
                a_x = ex_x.prepare_args(*asm_x.schur_arguments(device=False))
                o_x = ex_x(*a_x)
                np.asarray(o_x[0][:1, :1])
                xl_times.append(time.perf_counter() - t0)
            t_xl = min(xl_times)
            args_x = jax.device_put(
                ex_x.prepare_args(*asm_x.schur_arguments(device=False))
            )
            jax.block_until_ready(args_x)
            depth_x = min(16, hbm_fit(mesh_x.num_edges))
            best_x = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs_x = [ex_x(*args_x) for _ in range(depth_x)]
                np.asarray(outs_x[-1][0][:1, :1])
                best_x = min(best_x, (time.perf_counter() - t0) / depth_x)
            xl = {
                "generations": GENS_XL,
                "num_dofs": int(asm_x.num_dofs),
                "assemble_solve_ms": round(t_xl * 1e3, 3),
                "dofs_per_sec": round(asm_x.num_dofs / t_xl, 1),
                "pipelined_ms_per_solve": round(best_x * 1e3, 3),
                "pipelined_dofs_per_sec": round(asm_x.num_dofs / best_x, 1),
                "pipeline_depth": depth_x,
            }
            log(f"XL assemble+solve: best {t_xl * 1e3:.2f} ms "
                f"-> {asm_x.num_dofs / t_xl:.3e} dofs/s; pipelined x{depth_x} "
                f"{best_x * 1e3:.2f} ms/solve "
                f"-> {asm_x.num_dofs / best_x:.3e} dofs/s")
            del out_x, outs_x, o_x, args_x, ex_x, asm_x, mesh_x, G_x
        except Exception as e:  # pragma: no cover - defensive
            log(f"XL stage skipped: {e!r}")
            xl = None

    # --- lattice scale point: 512² capillary grid (262k junctions,
    # 1.8M dofs, fully cyclic — a topology the reference's generators
    # cannot produce).  Exercises the gather-free grid executor over the
    # exact separable-DCT λ solve.  Failure-isolated; NXFX_BENCH_LATTICE=0
    # skips.
    lattice = None
    if os.environ.get("NXFX_BENCH_LATTICE", "1") != "0" and stage_ok("lattice", 300):
        try:
            from networks_fenicsx_tpu.network_generation import make_grid
            from networks_fenicsx_tpu.solver import _GridPlan

            n_lat = int(os.environ.get("NXFX_BENCH_LATTICE_N", "512"))
            t0 = time.perf_counter()
            G_l = make_grid(n_lat, n_lat, arrays=True)
            mesh_l = NetworkMesh(G_l, N=1, color_strategy="fast")
            import dataclasses

            asm_l = HydraulicNetworkAssembler(mesh_l)
            asm_l.compute_forms(p_bc_ex=p_bc, R=1.0)
            # Request the exact DCT solve explicitly: below the dense
            # threshold "auto" resolves to peel-then-core, which has no
            # internal layout (and no prepare_args).
            opts_l = dataclasses.replace(opts, schur_method="dct")
            ex_l = build_schur_executor(
                asm_l, opts_l, outputs="blocks", internal_layout=True
            )
            engaged = isinstance(getattr(ex_l, "blocked_plan", None), _GridPlan)
            log(f"lattice: {n_lat}x{n_lat}, {mesh_l.num_edges} vessels, "
                f"{asm_l.num_dofs} dofs, grid plan engaged: {engaged} "
                f"({time.perf_counter() - t0:.1f}s build)")
            args_l = jax.device_put(
                ex_l.prepare_args(*asm_l.schur_arguments(device=False))
            )
            jax.block_until_ready(args_l)
            out_l = ex_l(*args_l)
            np.asarray(out_l[0][:1, :1])  # warm (compile) + sync
            depth_l = 16
            best_l = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs_l = [ex_l(*args_l) for _ in range(depth_l)]
                np.asarray(outs_l[-1][0][:1, :1])
                best_l = min(best_l, (time.perf_counter() - t0) / depth_l)
            # accuracy vs the exact stencil operator: residual of the λ
            # system is returned by the executor
            res_l = float(out_l[4]) / max(float(out_l[5]), 1e-300)
            lattice = {
                "grid": n_lat,
                "num_dofs": int(asm_l.num_dofs),
                "grid_plan": engaged,
                "pipelined_ms_per_solve": round(best_l * 1e3, 3),
                "pipelined_dofs_per_sec": round(asm_l.num_dofs / best_l, 1),
                "lambda_rel_residual": res_l,
            }
            log(f"lattice pipelined x{depth_l}: {best_l * 1e3:.2f} ms/solve "
                f"-> {asm_l.num_dofs / best_l:.3e} dofs/s "
                f"(lambda rel residual {res_l:.1e})")
            del out_l, outs_l, args_l, ex_l, asm_l, mesh_l, G_l
        except Exception as e:  # pragma: no cover - defensive
            log(f"lattice stage skipped: {e!r}")
            lattice = None

    # --- shared scale-point harness for the topology-family stages
    # (unstructured web, perfusion bed, per-edge-R lattice): plan and
    # first-call (compile) times, fused-executor synchronized
    # assemble+solve, deep-pipelined re-dispatch, SuperLU factor+solve of
    # the identical system as baseline + accuracy oracle.  An accuracy
    # mismatch is RECORDED in the stage dict (never swallowed by the
    # callers' environment-failure isolation).
    def _scale_stage(label, mesh_s, asm_s, recompute, extras,
                     include_factor_reuse=False):
        from networks_fenicsx_tpu.solver import (
            _cached_tree_plan,
            _flatten_blocks_host,
        )

        t_build = time.perf_counter()
        # memoized on the assembler: build_schur_executor and the
        # factor-reuse TreeFactorization below reuse this same plan
        # (symbolic phase + device payload paid once)
        plan_s = _cached_tree_plan(asm_s, attach=True)
        stats_s = plan_s.core_plan.stats if plan_s.core_plan else None
        ex_s = build_schur_executor(
            asm_s, opts, outputs="blocks", internal_layout=True
        )
        prep_s = getattr(ex_s, "prepare_args", None)
        t_plan = time.perf_counter() - t_build
        log(f"{label}: {mesh_s.num_edges} vessels, {asm_s.num_dofs} dofs, "
            f"core plan {stats_s} ({t_plan:.1f}s plan)")
        a_s = asm_s.schur_arguments(device=prep_s is None)
        if prep_s is not None:
            a_s = prep_s(*a_s)
        args_s = jax.device_put(a_s)
        jax.block_until_ready(args_s)
        t0 = time.perf_counter()
        out_s = ex_s(*args_s)
        np.asarray(out_s[0][:1, :1])  # warm (compile) + sync
        t_warm = time.perf_counter() - t0
        log(f"{label}: first call (compile or cache load) {t_warm:.1f}s")
        # synchronized assemble+solve (forms recomputed per rep)
        times_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            recompute()
            aa = asm_s.schur_arguments(device=prep_s is None)
            if prep_s is not None:
                aa = prep_s(*aa)
            o_s = ex_s(*aa)
            np.asarray(o_s[0][:1, :1])
            times_s.append(time.perf_counter() - t0)
        t_sync = min(times_s)
        depth_s = 16
        best_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            outs_s = [ex_s(*args_s) for _ in range(depth_s)]
            np.asarray(outs_s[-1][0][:1, :1])
            best_s = min(best_s, (time.perf_counter() - t0) / depth_s)
        # SuperLU baseline + accuracy on the identical system
        import scipy.sparse.linalg as _spla

        A_s, b_s = asm_s.host_system()
        lu_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            x_lu_s = _spla.splu(A_s).solve(b_s)
            lu_times.append(time.perf_counter() - t0)
        t_lu_s = float(np.median(lu_times))
        x_s = _flatten_blocks_host(
            out_s[0], out_s[1], out_s[2], mesh_s.edge_color,
            edge_order=getattr(ex_s, "edge_order", None),
            bif_order=getattr(ex_s, "bif_order", None),
        )
        err_s = float(
            np.max(np.abs(x_s - x_lu_s)) / max(1.0, np.abs(x_lu_s).max())
        )
        record = {
            **extras,
            "vessels": int(mesh_s.num_edges),
            "num_dofs": int(asm_s.num_dofs),
            "core_plan": stats_s,
            "assemble_solve_ms": round(t_sync * 1e3, 3),
            "pipelined_ms_per_solve": round(best_s * 1e3, 3),
            "superlu_ms_median": round(t_lu_s * 1e3, 3),
            "vs_superlu": round(t_lu_s / t_sync, 2),
            "max_rel_err_vs_superlu": err_s,
            "plan_s": round(t_plan, 1),
            "warm_compile_s": round(t_warm, 1),
        }
        if include_factor_reuse:
            # factor-once / re-solve-per-rhs (the MUMPS factor-reuse
            # contract): conductance-side factor cached, rhs-only solves
            # pipelined.  Failure-logged, never fatal to the stage.
            try:
                from networks_fenicsx_tpu.solver import build_tree_factorization

                fac_s = build_tree_factorization(asm_s, opts)
                Rs_a, fs_a, ss_a, es_a = asm_s.schur_arguments(device=False)
                st_s = jax.block_until_ready(fac_s.factor(Rs_a))
                rhs_s = jax.device_put(fac_s.prepare_rhs(fs_a, ss_a, es_a))
                of_s = fac_s.solve_prepared(st_s, rhs_s)
                np.asarray(of_s[0][:1, :1])  # warm + sync
                bf_s = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    ofs_s = [
                        fac_s.solve_prepared(st_s, rhs_s)
                        for _ in range(depth_s)
                    ]
                    np.asarray(ofs_s[-1][0][:1, :1])
                    bf_s = min(bf_s, (time.perf_counter() - t0) / depth_s)
                record["factor_reuse_ms_per_solve"] = round(bf_s * 1e3, 3)
                log(f"{label} factor-reuse (rhs-only): "
                    f"{bf_s * 1e3:.2f} ms/solve")
            except Exception as e:  # pragma: no cover - defensive
                log(f"{label} factor-reuse skipped: {e!r}")
                record["factor_reuse_ms_per_solve"] = None
            # the honest steady-state serving number: a production server
            # holds the factor and re-solves per rhs (the MUMPS serving
            # contract); the fused number re-runs the conductance-side
            # factor every dispatch
            fr = record["factor_reuse_ms_per_solve"]
            record["steady_state_ms_per_solve"] = (
                fr if fr is not None else record["pipelined_ms_per_solve"]
            )
        log(f"{label} assemble+solve: best {t_sync * 1e3:.2f} ms, pipelined "
            f"x{depth_s} {best_s * 1e3:.2f} ms/solve; SuperLU "
            f"{t_lu_s * 1e3:.1f} ms ({t_lu_s / t_sync:.1f}x); err {err_s:.1e}")
        if err_s >= 1e-8:
            # recorded IN the artifact — distinguishable from an
            # environment skip (which leaves the stage null)
            record["error"] = f"accuracy mismatch vs SuperLU: {err_s:.3e}"
            log(f"{label} ACCURACY MISMATCH vs SuperLU: {err_s:.3e}")
        return record

    # --- unstructured scale point: ~10k-junction random cyclic capillary
    # web (Delaunay family, make_random_network) through the sparse
    # min-degree core elimination — the MUMPS-generality path.
    # Failure-isolated; NXFX_BENCH_UNSTRUCTURED=0 skips.
    unstructured = None
    if (os.environ.get("NXFX_BENCH_UNSTRUCTURED", "1") != "0"
            and stage_ok("unstructured", 360)):
        try:
            from networks_fenicsx_tpu.network_generation import make_random_network

            n_un = int(os.environ.get("NXFX_BENCH_UNSTRUCTURED_N", "10000"))
            G_u = make_random_network(n_un, keep=0.7, seed=42, arrays=True)
            mesh_u = NetworkMesh(G_u, N=2, color_strategy="fast")
            asm_u = HydraulicNetworkAssembler(mesh_u)
            rng_u = np.random.default_rng(1)
            R_u = rng_u.uniform(0.5, 3.0, mesh_u.num_edges)
            asm_u.compute_forms(p_bc_ex=p_bc, R=R_u)
            unstructured = _scale_stage(
                "unstructured",
                mesh_u,
                asm_u,
                lambda: asm_u.compute_forms(p_bc_ex=p_bc, R=R_u),
                {"junctions": n_un},
                include_factor_reuse=True,
            )
            del asm_u, mesh_u, G_u
        except Exception as e:  # pragma: no cover - defensive
            log(f"unstructured stage skipped: {e!r}")
            unstructured = None

    # --- composite scale point: arterio-venous perfusion bed
    # (make_vascular_bed — Murray's-law tree + capillary lattice + venous
    # drain).  The structure-adaptive peel-then-core elimination on the
    # composite.  Failure-isolated; NXFX_BENCH_BED=0 skips.
    bed = None
    if os.environ.get("NXFX_BENCH_BED", "1") != "0" and stage_ok("bed", 300):
        try:
            from networks_fenicsx_tpu.network_generation import make_vascular_bed

            bg = int(os.environ.get("NXFX_BENCH_BED_GENS", "5"))
            bx = int(os.environ.get("NXFX_BENCH_BED_NX", "96"))
            by = int(os.environ.get("NXFX_BENCH_BED_NY", "64"))
            G_b = make_vascular_bed(bg, bx, by, arrays=True)
            mesh_b = NetworkMesh(G_b, N=2, color_strategy="fast")
            asm_b = HydraulicNetworkAssembler(mesh_b)
            R_b = 1.0 / mesh_b.edge_radius**4
            asm_b.compute_forms(p_bc_ex=p_bc, R=R_b)
            bed = _scale_stage(
                "bed",
                mesh_b,
                asm_b,
                lambda: asm_b.compute_forms(p_bc_ex=p_bc, R=R_b),
                {"terminals": 2**bg, "lattice": [bx, by]},
            )
            del asm_b, mesh_b, G_b
        except Exception as e:  # pragma: no cover - defensive
            log(f"bed stage skipped: {e!r}")
            bed = None

    def record() -> dict:
        """The run's record as measured so far (stages not yet run are
        ``None``)."""
        return {
            "metric": f"arterial_tree_{GENS}gen_assemble_solve_dofs_per_sec",
            "value": round(dofs_per_sec, 1),
            "unit": "dofs/s",
            "vs_baseline": (
                round(t_baseline / t_solve, 3) if t_baseline is not None else None
            ),
            "detail": {
                "generations": GENS,
                "elements_per_vessel": N_ELEM,
                "num_dofs": int(n_dofs),
                "assemble_solve_ms": round(t_solve * 1e3, 3),
                "pipelined_ms_per_solve": round(t_pipe * 1e3, 3),
                "pipelined_dofs_per_sec": round(pipe_dofs_per_sec, 1),
                "pipeline_depth": K,
                "pipelined_deep_ms_per_solve": round(t_pipe_deep * 1e3, 3),
                "pipelined_deep_dofs_per_sec": round(n_dofs / t_pipe_deep, 1),
                "pipeline_depth_deep": K_deep,
                "batched_ms_per_solve": round(best_b * 1e3, 3) if best_b else None,
                "batch_size": S if best_b else None,
                "pipelined_f32_ms_per_solve": (
                    round(t_pipe_f32 * 1e3, 3) if t_pipe_f32 else None
                ),
                "pipelined_mixed_out_f32_ms_per_solve": (
                    round(t_pipe_mixed * 1e3, 3) if t_pipe_mixed else None
                ),
                "pipelined_factor_reuse_ms_per_solve": (
                    round(t_pipe_factor * 1e3, 3) if t_pipe_factor else None
                ),
                "pipelined_level_scan_ms_per_solve": (
                    round(t_pipe_scan * 1e3, 3) if t_pipe_scan else None
                ),
                "baseline": "scipy SuperLU factor+solve of the identical system "
                "(MUMPS stand-in; host-load dependent)",
                "baseline_superlu_ms_median": (
                    round(t_baseline * 1e3, 3) if t_baseline is not None else None
                ),
                "baseline_superlu_ms_min": (
                    round(min(base_times) * 1e3, 3) if base_times else None
                ),
                "baseline_superlu_ms_max": (
                    round(max(base_times) * 1e3, 3) if base_times else None
                ),
                "warmup_s": round(t_warmup, 3),
                "max_rel_err_vs_direct": err,
                "xl": xl,
                "lattice": lattice,
                "unstructured": unstructured,
                "bed": bed,
                "supernodal": supernodal,
                "device": device,
            },
        }

    # --- supernodal scale point: 320² per-edge-R lattice — min-degree
    # blows its fill budget and the tree-multifrontal engine carries the
    # exact direct solve (batched dense fronts + extend-add).  Runs in
    # this process; its cold compile is the largest set-up cost, so the
    # stage is skipped (and says so) when the deadline cannot hold it.
    # Failure-isolated; NXFX_BENCH_SUPERNODAL=0 skips.
    supernodal = None
    if (os.environ.get("NXFX_BENCH_SUPERNODAL", "1") != "0"
            and stage_ok("supernodal", 900)):
        # An XLA compile cannot be interrupted: emit the record so far, so
        # a run cut inside this stage still ends on a valid headline line.
        _emit_record(record())
        try:
            from networks_fenicsx_tpu.network_generation import make_grid

            n_sn = int(os.environ.get("NXFX_BENCH_SUPERNODAL_N", "320"))
            G_s = make_grid(n_sn, n_sn, arrays=True)
            mesh_s = NetworkMesh(G_s, N=1, color_strategy="fast")
            asm_s = HydraulicNetworkAssembler(mesh_s)
            R_s = np.random.default_rng(n_sn).uniform(0.5, 2.0, mesh_s.num_edges)
            asm_s.compute_forms(p_bc_ex=p_bc, R=R_s)
            supernodal = _scale_stage(
                "supernodal",
                mesh_s,
                asm_s,
                lambda: asm_s.compute_forms(p_bc_ex=p_bc, R=R_s),
                {"lattice": [n_sn, n_sn]},
                include_factor_reuse=True,
            )
            del asm_s, mesh_s, G_s
        except Exception as e:  # pragma: no cover - defensive
            log(f"supernodal stage skipped: {e!r}")
            supernodal = None

    _emit_record(record())


if __name__ == "__main__":
    try:
        main(device_record())
    except BaseException as e:  # noqa: BLE001 — always leave a parseable record
        import traceback

        traceback.print_exc(file=sys.stderr)
        _emit_failure(f"{type(e).__name__}: {e}")
        sys.exit(1)
