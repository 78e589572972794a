"""Cold vs warm compilation study — the FFCx-cache analog.

The reference benchmarks FFCx's on-disk kernel cache by timing ``fem.form``
with a wiped cache directory ("Compile") and again with a warm one
("CompileCached") (reference ``demos/demo_perf.py:41-47,116-132``).  Here
the per-problem compilation is XLA's, and the persistent artifact is the
serialized executable: this script times the first executor dispatch of a
fresh *process* twice — once with a wiped ``jax_compilation_cache_dir``
(cold: full XLA compile) and once with the directory left warm (cache
deserialization) — the apples-to-apples reproduction of the reference's
cache study.

The two children run one after the other and the parent never imports
JAX, so only one process holds the accelerator at a time.  The children
get the study's cache through ``JAX_COMPILATION_CACHE_DIR`` (default
``<checkout>/.jax_cache/study``, wiped before the cold run).

Usage::

    python scripts/compile_cache_study.py [--gens 12] [--elems 40] [--tree]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from networks_fenicsx_tpu.utils.platform import apply_platform_env, enable_compilation_cache
apply_platform_env()
enable_compilation_cache(min_compile_time_secs=0.0)
import jax
from networks_fenicsx_tpu import HydraulicNetworkAssembler, NetworkMesh, SolverOptions
from networks_fenicsx_tpu.network_generation import make_arterial_tree, make_tree
from networks_fenicsx_tpu.solver import build_schur_executor

if {tree!r}:
    G = make_tree(n={gens}, H=1.0, W=1.0)
else:
    G = make_arterial_tree(N={gens}, direction=np.array([0.1, 1.0, 0.0]))
mesh = NetworkMesh(G, N={elems}, color_strategy="fast")
asm = HydraulicNetworkAssembler(mesh)
R = None if {tree!r} else 1.0 / mesh.edge_radius**4
asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
executor = build_schur_executor(asm, SolverOptions())
args = asm.schur_arguments()
t0 = time.perf_counter()
out = executor(*args)
jax.block_until_ready(out)
float(out[2])  # true sync: value pull
warmup = time.perf_counter() - t0
t0 = time.perf_counter()
jax.block_until_ready(executor(*args))
steady = time.perf_counter() - t0
print(json.dumps({{"warmup_s": warmup, "steady_s": steady,
                   "num_dofs": int(asm.num_dofs),
                   "backend": jax.default_backend()}}))
"""


def run_child(cache: Path, gens: int, elems: int, tree: bool) -> dict:
    code = CHILD.format(repo=str(REPO), gens=gens, elems=elems, tree=tree)
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env=env,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--elems", type=int, default=40)
    ap.add_argument("--tree", action="store_true", help="binary tree instead of arterial")
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args()

    cache = Path(args.cache_dir or REPO / ".jax_cache" / "study")
    shutil.rmtree(cache, ignore_errors=True)

    t0 = time.perf_counter()
    cold = run_child(cache, args.gens, args.elems, args.tree)
    t_cold_proc = time.perf_counter() - t0
    print(f"cold:  warmup {cold['warmup_s']:.3f}s  steady {cold['steady_s'] * 1e3:.1f}ms"
          f"  (process total {t_cold_proc:.1f}s, {cold['num_dofs']} dofs,"
          f" backend {cold['backend']})")

    t0 = time.perf_counter()
    warm = run_child(cache, args.gens, args.elems, args.tree)
    t_warm_proc = time.perf_counter() - t0
    print(f"warm:  warmup {warm['warmup_s']:.3f}s  steady {warm['steady_s'] * 1e3:.1f}ms"
          f"  (process total {t_warm_proc:.1f}s)")
    print(json.dumps({
        "metric": "compile_cache_speedup",
        "cold_warmup_s": round(cold["warmup_s"], 3),
        "warm_warmup_s": round(warm["warmup_s"], 3),
        "speedup": round(cold["warmup_s"] / max(warm["warmup_s"], 1e-9), 2),
        "num_dofs": cold["num_dofs"],
        "backend": cold["backend"],
    }))


if __name__ == "__main__":
    main()
