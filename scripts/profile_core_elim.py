"""Stage-level profile of the supernodal core elimination (round-5 work).

Builds the per-edge-R lattice core plan directly from the lattice graph
(the same ND + multifrontal plan ``attach_core_plan`` produces for the
bench's supernodal stage) and times each phase of ``_core_factor`` /
``_core_apply`` as a separately-jitted program on the active backend:

  plan          host symbolic phase
  f_rounds      factor: sparse elimination rounds (folds + streams)
  f_fronts      factor: supernodal front Choleskys + extend-add
  a_fwd         apply: forward rhs sweep over the rounds
  a_fronts_dense apply: front forward sweep + dense tail + front backsub
  a_back        apply: round back-substitution

Usage: python scripts/profile_core_elim.py [n_lattice] [reps]
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from networks_fenicsx_tpu.ops.core_elim import (  # noqa: E402
    _fold_apply,
    _fold_apply_pre,
    nested_dissection_order,
    plan_core_elimination,
)
from networks_fenicsx_tpu.ops.scaled_cholesky import (  # noqa: E402
    scaled_cholesky_factor,
    scaled_cholesky_solve,
)
from networks_fenicsx_tpu.utils.platform import enable_compilation_cache  # noqa: E402


def lattice_core(n: int):
    """Core pairs of an n x n lattice (every junction is in a cycle)."""
    idx = np.arange(n * n).reshape(n, n)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    pairs = np.concatenate([h, v], axis=0)
    P = pairs.shape[0]
    core_pairs = np.concatenate(
        [pairs, np.arange(P, dtype=np.int64)[:, None]], axis=1
    )
    return core_pairs, n * n


# ---- staged copies of _core_factor / _core_apply internals ----


def factor_rounds(plan, dc, w_pairs):
    dtype = dc.dtype
    init_ext = jnp.concatenate(
        [-w_pairs[jnp.asarray(plan.init_slot)].astype(dtype), jnp.zeros(1, dtype)]
    )
    ustream = jnp.zeros(plan.mu_all + 1, dtype)
    d = dc
    rounds = []
    for rd in plan.rounds:
        e = jnp.asarray(rd.elim)
        a = init_ext[jnp.asarray(rd.init_idx)]
        if rd.u_read:
            a = a - _fold_apply_pre(ustream, rd.u_read).reshape(a.shape)
        inv = 1.0 / d[e]
        ainv = a * inv[:, None]
        s = _fold_apply((a * ainv).reshape(-1), rd.d_fold)
        s_ext = jnp.concatenate([s, jnp.zeros(1, dtype)])
        d = d - s_ext[jnp.asarray(rd.d_inv)]
        if rd.u_src_i.size:
            contrib = a.reshape(-1)[jnp.asarray(rd.u_src_i)] * ainv.reshape(-1)[
                jnp.asarray(rd.u_src_j)
            ]
            su = _fold_apply(contrib, rd.u_fold)
            ustream = jax.lax.dynamic_update_slice(ustream, su, (rd.u_off,))
        rounds.append((a, inv))
    return d, ustream, init_ext, tuple(rounds)


def factor_fronts(plan, d, ustream, init_ext):
    dtype = d.dtype
    pending = {}
    front_states = []
    ok = jnp.asarray(True)
    for fid, fr in enumerate(plan.fronts):
        w = int(fr.nodes.size)
        b = int(fr.bnd.size)
        F = jnp.zeros((w + b, w + b), dtype)
        F = F.at[jnp.arange(w), jnp.arange(w)].add(d[jnp.asarray(fr.nodes)])
        if fr.slot_val.size:
            sval = init_ext[jnp.asarray(fr.f_init)]
            if fr.f_fold:
                sval = sval - _fold_apply_pre(ustream, fr.f_fold)
            fi = jnp.asarray(fr.slot_i)
            fj = jnp.asarray(fr.slot_j)
            F = F.at[fi, fj].add(sval)
            F = F.at[fj, fi].add(sval)
        for cid, lminv in fr.consume:
            U = pending.pop(cid)
            Upad = jnp.pad(U, ((0, 1), (0, 1)))
            lmi = jnp.asarray(lminv)
            F = F + Upad[lmi[:, None], lmi[None, :]]
        C = jnp.linalg.cholesky(F[:w, :w])
        piv = jnp.diagonal(C)
        ok = ok & jnp.all(jnp.isfinite(piv)) & (jnp.min(piv) > 1e-12 * jnp.max(piv))
        if b:
            X = jax.scipy.linalg.cho_solve((C, True), F[:w, w:])
            pending[fid] = F[w:, w:] - F[w:, :w] @ X
        else:
            X = None
        front_states.append((C, X))
    return tuple(front_states), ok


def apply_fwd(plan, state_rounds, rc):
    dtype = rc.dtype
    r = rc
    saved = []
    for rd, (a, inv) in zip(plan.rounds, state_rounds):
        e = jnp.asarray(rd.elim)
        rv = r[e]
        ainv = a * inv[:, None]
        s = _fold_apply((ainv * rv[:, None]).reshape(-1), rd.d_fold)
        s_ext = jnp.concatenate([s, jnp.zeros(1, dtype)])
        r = r - s_ext[jnp.asarray(rd.d_inv)]
        saved.append((a, inv, rv))
    return r, tuple(saved)


def apply_fronts_dense(plan, fronts, fronts_ok, dense, r):
    dtype = r.dtype
    Bc = plan.n_core
    front_rv = []
    for fr, (C, X) in zip(plan.fronts, fronts):
        rv_f = r[jnp.asarray(fr.nodes)]
        front_rv.append(rv_f)
        if X is not None:
            r = r.at[jnp.asarray(fr.bnd)].add(-(X.T @ rv_f))
    lam = jnp.zeros(Bc + 1, dtype)
    if plan.dense_nodes.size:
        dn = jnp.asarray(plan.dense_nodes)
        lam_d = scaled_cholesky_solve(dense, r[dn])
        lam = lam.at[dn].set(lam_d)
    if plan.fronts:
        for fr, (C, X), rv_f in reversed(list(zip(plan.fronts, fronts, front_rv))):
            lam_s = jax.scipy.linalg.cho_solve((C, True), rv_f)
            if X is not None:
                lam_s = lam_s - X @ lam[jnp.asarray(fr.bnd)]
            lam = lam.at[jnp.asarray(fr.nodes)].set(lam_s)
        lam = jnp.where(fronts_ok, lam, jnp.nan)
    return lam


def apply_back(plan, saved, lam):
    dtype = lam.dtype
    for rd, (a, inv, rv) in zip(reversed(plan.rounds), reversed(saved)):
        lam_n = lam[jnp.asarray(rd.nbr_node)]
        new = (rv - jnp.sum(a * lam_n, axis=1)) * inv
        new_ext = jnp.concatenate([new, jnp.zeros(1, dtype)])
        e_inv = jnp.asarray(rd.e_inv)
        lam = jnp.where(e_inv < rd.elim.shape[0], new_ext[e_inv], lam)
    return lam[: plan.n_core]


def _pull(out) -> None:
    """Synchronize by pulling one element to the host (the same sync
    bench.py uses)."""
    leaf = jax.tree_util.tree_leaves(out)[-1]
    np.asarray(jax.numpy.ravel(leaf)[:1])


def bench_fn(name, fn, *args, reps=3):
    t0 = time.perf_counter()
    out = fn(*args)
    _pull(out)
    t_compile = time.perf_counter() - t0
    # pipelined dispatch + ONE sync, so the host round trip of a
    # synchronized dispatch does not swamp sub-ms programs
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(reps)]
        _pull(outs[-1])
        best = min(best, (time.perf_counter() - t0) / reps)
        del outs
    print(f"{name:16s} {best * 1e3:9.2f} ms   (first call {t_compile:.1f}s)",
          flush=True)
    return out, best


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 192
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    print(f"backend: {jax.default_backend()}, lattice {n}x{n}", flush=True)

    core_pairs, n_core = lattice_core(n)
    t0 = time.perf_counter()
    nd = nested_dissection_order(core_pairs, n_core, leaf=8)
    t_nd = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_core_elimination(
        core_pairs, n_core, dense_cutoff=8192, kcap=64, order=nd,
        dense_cap=8192, supernodal_tail=True,
    )
    t_plan = time.perf_counter() - t0
    print(f"plan: nd {t_nd:.1f}s + symbolic {t_plan:.1f}s, stats {plan.stats}",
          flush=True)
    # fold-size audit
    tot_fold = 0
    for rd in plan.rounds:
        for lv in rd.d_fold:
            tot_fold += lv.size
        for lv in rd.u_read:
            tot_fold += lv.size
        for lv in rd.u_fold:
            tot_fold += lv.size
        tot_fold += rd.init_idx.size + rd.nbr_node.size
    print(f"round gather/fold elements: {tot_fold / 1e6:.1f} M "
          f"(index bytes {plan.index_bytes / 1e6:.0f} MB)", flush=True)

    rng = np.random.default_rng(0)
    w = rng.uniform(0.5, 3.0, core_pairs.shape[0])
    dc_h = np.zeros(n_core)
    np.add.at(dc_h, core_pairs[:, 0], w)
    np.add.at(dc_h, core_pairs[:, 1], w)
    dc_h = dc_h * 1.001 + 0.05
    rc_h = rng.standard_normal(n_core)

    plan_dev = jax.device_put(plan)
    dc = jnp.asarray(dc_h)
    wp = jnp.asarray(w)
    rc = jnp.asarray(rc_h)

    f_rounds = jax.jit(factor_rounds)
    (d, ustream, init_ext, rounds_state), t1 = bench_fn(
        "f_rounds", f_rounds, plan_dev, dc, wp, reps=reps)
    f_fronts = jax.jit(factor_fronts)
    (fronts_state, ok), t2 = bench_fn(
        "f_fronts", f_fronts, plan_dev, d, ustream, init_ext, reps=reps)
    dense = None
    if plan.dense_nodes.size:
        def f_dense(plan, d, ustream, init_ext):
            dn = jnp.asarray(plan.dense_nodes)
            Bd = int(plan.dense_nodes.size)
            Lc = jnp.zeros((Bd, Bd), d.dtype)
            Lc = Lc.at[jnp.arange(Bd), jnp.arange(Bd)].add(d[dn])
            if plan.dense_pairs.shape[0]:
                di = jnp.asarray(plan.dense_pairs[:, 0])
                dj = jnp.asarray(plan.dense_pairs[:, 1])
                ov = init_ext[jnp.asarray(plan.dp_init)]
                if plan.dp_fold:
                    ov = ov - _fold_apply_pre(ustream, plan.dp_fold)
                Lc = Lc.at[di, dj].add(ov)
                Lc = Lc.at[dj, di].add(ov)
            return scaled_cholesky_factor(Lc)
        dense, t2b = bench_fn("f_dense", jax.jit(f_dense),
                              plan_dev, d, ustream, init_ext, reps=reps)

    a_fwd = jax.jit(apply_fwd)
    (r_out, saved), t3 = bench_fn("a_fwd", a_fwd, plan_dev, rounds_state, rc,
                                  reps=reps)
    a_fd = jax.jit(apply_fronts_dense)
    lam_top, t4 = bench_fn("a_fronts_dense", a_fd, plan_dev, fronts_state, ok,
                           dense, r_out, reps=reps)
    a_back = jax.jit(apply_back)
    lam, t5 = bench_fn("a_back", a_back, plan_dev, saved, lam_top, reps=reps)

    # correctness vs scipy
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = sp.csc_matrix(
        (np.concatenate([dc_h, -w, -w]),
         (np.concatenate([np.arange(n_core), core_pairs[:, 0], core_pairs[:, 1]]),
          np.concatenate([np.arange(n_core), core_pairs[:, 1], core_pairs[:, 0]]))),
        shape=(n_core, n_core),
    )
    t0 = time.perf_counter()
    x_ref = spla.splu(A).solve(rc_h)
    t_slu = time.perf_counter() - t0
    err = np.max(np.abs(np.asarray(lam) - x_ref)) / np.max(np.abs(x_ref))
    print(f"SuperLU factor+solve: {t_slu * 1e3:.1f} ms; rel err {err:.2e}",
          flush=True)
    print(f"TOTAL factor {1e3 * (t1 + t2 + (t2b if dense is not None else 0)):.1f} ms"
          f" + apply {1e3 * (t3 + t4 + t5):.1f} ms", flush=True)


if __name__ == "__main__":
    main()
