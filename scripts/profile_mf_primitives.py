"""Microbenchmark of the batched dense primitives a tree-multifrontal
core executor leans on: batched f64/f32 Cholesky, cho_solve, matmul and
batched 2-D gathers at the shapes a 320² per-edge-R lattice produces
(1600 leaf fronts ~112², halving counts up to one ~640² top separator
front), plus the lattice path's separable transform at 512² as
``jax.scipy.fft.dctn``/``idctn`` against the matmul DCT the solver uses.

Prints the device and, on a GPU, the card's name and power limit.

Usage: python scripts/profile_mf_primitives.py
"""

import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from networks_fenicsx_tpu.utils.platform import enable_compilation_cache  # noqa: E402


def _pull(out):
    leaf = jax.tree_util.tree_leaves(out)[-1]
    np.asarray(jnp.ravel(leaf)[:1])


def bench(name, fn, *args, reps=8):
    t0 = time.perf_counter()
    out = fn(*args)
    _pull(out)
    t_c = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(reps)]
        _pull(outs[-1])
        best = min(best, (time.perf_counter() - t0) / reps)
        del outs
    print(f"{name:42s} {best * 1e3:9.3f} ms  (first {t_c:.1f}s)", flush=True)
    return best


def main():
    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind}", flush=True)
    if d.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
        print(f"card: {smi.stdout.strip()}", flush=True)
    rng = np.random.default_rng(0)

    # separable 2-D DCT-II + inverse at 512²: FFT-based dctn vs matmuls
    n = 512
    j = np.arange(n)
    D = np.cos(np.pi * (j[None, :] + 0.5) * j[:, None] / n) * np.sqrt(2.0 / n)
    D[0] *= np.sqrt(0.5)
    hi = jax.lax.Precision.HIGHEST
    for dt in (jnp.float64, jnp.float32):
        tag = "f64" if dt == jnp.float64 else "f32"
        X = jnp.asarray(rng.standard_normal((n, n)), dt)
        Dd = jnp.asarray(D, dt)
        fft_pair = jax.jit(lambda x: jax.scipy.fft.idctn(
            jax.scipy.fft.dctn(x, norm="ortho") * 0.5, norm="ortho"))
        mm_pair = jax.jit(lambda x, D: jnp.matmul(
            jnp.matmul(D.T, jnp.matmul(jnp.matmul(D, x, precision=hi), D.T,
                                       precision=hi) * 0.5, precision=hi),
            D, precision=hi))
        bench(f"{tag} dctn+idctn ({n},{n})", fft_pair, X)
        bench(f"{tag} matmul DCT pair ({n},{n})", mm_pair, X, Dd)

    for dt in (jnp.float64, jnp.float32):
        tag = "f64" if dt == jnp.float64 else "f32"
        for (k, w, m) in [(1600, 64, 112), (400, 16, 64), (16, 64, 256),
                          (2, 320, 960), (1, 640, 640)]:
            b = m - w
            A = rng.standard_normal((k, w, w))
            A = jnp.asarray(A @ np.swapaxes(A, 1, 2) + w * np.eye(w), dtype=dt)
            Bm = jnp.asarray(rng.standard_normal((k, w, b)), dtype=dt)
            chol = jax.jit(jnp.linalg.cholesky)
            bench(f"{tag} chol ({k},{w},{w})", chol, A)
            C = chol(A)
            cs = jax.jit(lambda C, Bm: jax.scipy.linalg.cho_solve((C, True), Bm))
            bench(f"{tag} cho_solve ({k},{w},{b})", cs, C, Bm)
            X = cs(C, Bm)
            mm = jax.jit(lambda Bm, X: jnp.einsum("kwb,kwc->kbc", Bm, X))
            bench(f"{tag} schur mm ({k},{b},{b})", mm, Bm, X)
            # explicit triangular inverse (factor-side cost) vs the
            # matvec-only apply it enables (serving-side win)
            inv_t = jax.jit(lambda C: jax.lax.linalg.triangular_solve(
                C, jnp.broadcast_to(jnp.eye(C.shape[-1], dtype=C.dtype),
                                    C.shape),
                left_side=True, lower=True))
            bench(f"{tag} tri inverse ({k},{w},{w})", inv_t, C)
            Li = inv_t(C)
            rv = jnp.asarray(rng.standard_normal((k, w, 1)), dt)
            mv = jax.jit(lambda Li, rv: jnp.swapaxes(Li, 1, 2)
                         @ (Li @ rv))
            bench(f"{tag} inv-apply matvec ({k},{w})", mv, Li, rv)
            cs1 = jax.jit(
                lambda C, rv: jax.scipy.linalg.cho_solve((C, True), rv))
            bench(f"{tag} cho_solve vec ({k},{w})", cs1, C, rv)

    # batched extend-add gather: U-pool (k, u+1, u+1) -> (k, m, m)
    for dt in (jnp.float64,):
        for (k, u, m) in [(1600, 40, 112), (800, 112, 160), (2, 640, 960)]:
            Upool = jnp.asarray(rng.standard_normal((k + 1, u + 1, u + 1)), dt)
            cidx = jnp.asarray(rng.integers(0, k + 1, k), jnp.int32)
            lminv = jnp.asarray(rng.integers(0, u + 1, (k, m)), jnp.int32)

            def ext_add(Upool, cidx, lminv):
                Us = Upool[cidx]  # (k, u+1, u+1)
                return Us[jnp.arange(cidx.shape[0])[:, None, None],
                          lminv[:, :, None], lminv[:, None, :]]

            bench(f"f64 extend-add gather ({k},{m},{m})",
                  jax.jit(ext_add), Upool, cidx, lminv)

    # strip assembly gather: vals (P0+1,) -> (k, w, m)
    for (k, w, m, P0) in [(1600, 64, 112, 204160)]:
        vals = jnp.asarray(rng.standard_normal(P0 + 1))
        smap = jnp.asarray(rng.integers(0, P0 + 1, (k, w, m)), jnp.int32)
        bench(f"f64 strip gather ({k},{w},{m})",
              jax.jit(lambda v, s: v[s]), vals, smap)

    # plain big gathers for scale: (n,) from (n,)
    for n in (102_400, 1_600_000):
        v = jnp.asarray(rng.standard_normal(n))
        ix = jnp.asarray(rng.integers(0, n, n), jnp.int32)
        bench(f"f64 random gather ({n},)", jax.jit(lambda v, i: v[i]), v, ix)


if __name__ == "__main__":
    main()
