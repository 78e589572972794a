"""Serving-loop demo: pipelined dispatch of the fused blocked solve.

A production serving loop keeps coefficients device-resident, dispatches
solves back-to-back, and synchronizes only when a result is consumed —
JAX's async dispatch overlaps each solve's execution with the next
dispatch, so steady-state throughput is set by the device program alone
(see docs/solvers.md "Serving: pipelined dispatch").

It prints the per-solve time at the given pipeline depth.  Run with
``NXFX_PLATFORM=cpu`` for a CPU demonstration (same code path).

Usage::

    python demos/demo_serving.py [generations] [depth]
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

if os.environ.get("NXFX_PLATFORM"):
    import jax

    jax.config.update("jax_platforms", os.environ["NXFX_PLATFORM"])

import jax

from networks_fenicsx_tpu import (
    HydraulicNetworkAssembler,
    NetworkMesh,
    SolverOptions,
)
from networks_fenicsx_tpu.network_generation import make_arterial_tree
from networks_fenicsx_tpu.solver import build_schur_executor
from networks_fenicsx_tpu.utils.platform import enable_compilation_cache

GENS = int(sys.argv[1]) if len(sys.argv) > 1 else int(os.environ.get("NXFX_SERVE_GENS", "10"))
DEPTH = int(sys.argv[2]) if len(sys.argv) > 2 else 32

enable_compilation_cache()

G = make_arterial_tree(N=GENS, direction=np.array([0.1, 1.0, 0.0]), arrays=True)
mesh = NetworkMesh(G, N=40, color_strategy="fast")
asm = HydraulicNetworkAssembler(mesh)
asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mesh.edge_radius**4)
print(f"{mesh.num_edges} vessels, {asm.num_dofs} dofs, backend {jax.default_backend()}")

executor = build_schur_executor(
    asm, SolverOptions(), outputs="blocks", internal_layout=True
)
prepare = getattr(executor, "prepare_args", None)
args = asm.schur_arguments(device=prepare is None)
if prepare is not None:
    args = prepare(*args)
args = jax.device_put(args)  # model state stays device-resident
jax.block_until_ready(args)

# warmup: compile (or cache load) + first device->host pull
t0 = time.perf_counter()
out = executor(*args)
np.asarray(out[0][:1, :1])
print(f"warmup {time.perf_counter() - t0:.2f}s")

# steady state: DEPTH requests in flight, one sync per batch
best = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    outs = [executor(*args) for _ in range(DEPTH)]
    np.asarray(outs[-1][0][:1, :1])
    best = min(best, (time.perf_counter() - t0) / DEPTH)
print(
    f"serving x{DEPTH}: {best * 1e3:.2f} ms/solve "
    f"({asm.num_dofs / best:.2e} dofs/s steady-state)"
)

# consume one result: per-edge root flux and junction multipliers
q_T, p_T, lam = outs[-1][0], outs[-1][1], outs[-1][2]
finite = bool(outs[-1][-1])
print(f"finite={finite}  root q={float(np.asarray(q_T[0, :1])[0]):.5f}  "
      f"|lambda|max={float(np.max(np.abs(np.asarray(lam)))):.5f}")
assert finite
