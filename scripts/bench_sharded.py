"""Sharded-blocked vs serial-blocked per-solve wall clock (virtual mesh).

Runs the n=20 tree (1,048,575 edges, 524,287 multipliers, N=1) through
both executors on the CPU backend — serial on one device, sharded blocked
over ``NXFX_CPU_DEVICES`` (default 8) virtual devices — and reports
pipelined ms/solve for each.  The virtual devices share one host's cores,
so this is NOT a speedup measurement; it demonstrates that the sharded
blocked program's per-solve cost stays within the same ballpark as the
serial blocked program (VERDICT round-2 item 1 "done when"), i.e. the
decomposition adds no super-constant overhead.  Run on real multi-GPU
hardware (``chip_smoke.py --multi`` checks the same paths there) for
collective costs.

Usage: NXFX_CPU_DEVICES=8 python scripts/bench_sharded.py [n] [N]
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", int(os.environ.get("NXFX_CPU_DEVICES", "8")))

import numpy as np  # noqa: E402

from networks_fenicsx_tpu import (  # noqa: E402
    HydraulicNetworkAssembler,
    NetworkMesh,
    SolverOptions,
)
from networks_fenicsx_tpu.network_generation import make_tree  # noqa: E402
from networks_fenicsx_tpu.parallel.blocked_sharded import (  # noqa: E402
    build_sharded_blocked_executor,
    plan_sharded_blocked,
)
from networks_fenicsx_tpu.parallel.sharding import make_device_mesh  # noqa: E402
from networks_fenicsx_tpu.solver import build_schur_executor  # noqa: E402


def pipelined(fn, args, depth=8, rounds=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(depth)]
        jax.block_until_ready(outs[-1])
        best = min(best, (time.perf_counter() - t0) / depth)
    return best


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    D = len(jax.devices())
    t0 = time.perf_counter()
    G = make_tree(n, 1.0, 2.0, arrays=True)
    mesh = NetworkMesh(G, N=N, color_strategy="fast")
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    print(f"n={n} N={N}: {mesh.num_edges} edges, {mesh.num_multipliers} "
          f"multipliers, {asm.num_dofs} dofs ({time.perf_counter() - t0:.1f}s build)")

    # serial blocked
    ex_s = build_schur_executor(asm, SolverOptions(), outputs="blocks", internal_layout=True)
    args_s = ex_s.prepare_args(*asm.schur_arguments(device=False))
    args_s = jax.device_put(args_s)
    t_serial = pipelined(ex_s, args_s)
    print(f"serial blocked (1 device): {t_serial * 1e3:.2f} ms/solve")

    # sharded blocked
    plan = plan_sharded_blocked(asm, D)
    assert plan is not None, "sharded blocked plan infeasible"
    dmesh = make_device_mesh(jax.devices())
    ex_d = build_sharded_blocked_executor(asm, plan, dmesh, "edges")
    args_d = ex_d.prepare_args(*asm.schur_arguments(device=False))
    t_shard = pipelined(ex_d, args_d)
    print(f"sharded blocked ({D} virtual devices, |T|={plan.Tn}): "
          f"{t_shard * 1e3:.2f} ms/solve")
    print(f"ratio sharded/serial: {t_shard / t_serial:.2f}x "
          f"(same physical host — structural overhead check, not a speedup)")


if __name__ == "__main__":
    main()
