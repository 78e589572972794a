"""Sharded blocked-sibling elimination: the fast executor layout, multi-chip.

Round 2's multi-device paths always ran the GENERAL ``(E, N, 2, 2)``
edge-data layout, so on a real pod the flagship per-device program would
have paid the interleave idioms the serial blocked executor eliminates
(within-row reorders instead of contiguous slices/adds/concats).  This
module gives the sharded path the same interleave-free device program,
the analog of MUMPS running its multifrontal
elimination in parallel over MPI ranks (reference
``src/networks_fenicsx/solver.py:58-65``):

* the uniformly-K-ary bifurcation forest is CUT at the shallowest level
  ``t`` whose width divides the device count ``D``; each device owns
  ``m_t / D`` complete subtrees — identically-shaped on every device, so
  ``shard_map`` traces ONE local program whose elimination is the same
  slice/add/concat blocked kernel as the serial path
  (:func:`networks_fenicsx_tpu.solver._blocked_forward` /
  ``_blocked_backward``, literally reused);
* the tiny top forest ``T`` (the ``Σ_{ℓ<t} m_ℓ`` bifurcations above the
  cut — a handful of nodes) is assembled from per-device contributions
  with ONE ``psum`` over the mesh axis and solved identically on every
  device (replicated dense Cholesky), replacing ghost updates;
* back-substitution, the λ→edge expansion and the j-major solution
  blocks are purely local.

Per-solve cross-device traffic is three ``psum``s of O(|T|) arrays —
independent of E, B and N.
"""

from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..solver import (
    _BlockedPlan,
    _blocked_backward,
    _blocked_condense,
    _blocked_csr,
    _blocked_forward,
    _blocked_lambda_to_edges,
    _blocked_walk,
    _plan_blocked,
)

try:  # jax >= 0.7 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

__all__ = ["ShardedBlockedPlan", "plan_sharded_blocked", "build_sharded_blocked_executor"]


class ShardedBlockedPlan(typing.NamedTuple):
    """Host-static plan for the sharded blocked elimination.

    Arrays with a leading ``D`` axis are sharded over the device mesh;
    the rest are baked into the traced program as constants.
    """

    D: int
    Tn: int  # top-forest size (0 when the root level already divides D)
    E_loc: int  # per-device edge rows (local subtree + T share + pad)
    E_sub: int  # local subtree edges (occupy rows [0, E_sub))
    B_sub: int  # local bifurcations per device
    c: int  # chunk roots per device
    local_plan: _BlockedPlan  # identical level structure on every device
    # --- per-device static rows (sharded shard_map operands)
    edge_rows: np.ndarray  # (D, E_loc) public edge id, -1 for pad
    h: np.ndarray  # (D, E_loc) edge lengths (pad: 1.0)
    s_is_bif: np.ndarray  # (D, E_loc)
    t_is_bif: np.ndarray  # (D, E_loc)
    tT_idx: np.ndarray  # (D, E_loc) target's T position (Tn if none)
    sT_idx: np.ndarray  # (D, E_loc) source's T position (Tn if none)
    pT_idx: np.ndarray  # (D, E_loc) T-pair child position for w_T (Tn if none)
    root_T: np.ndarray  # (D, c) parent T position of each chunk root (Tn if none)
    # --- replicated T structure (baked)
    T_parent: np.ndarray  # (Tn,) parent T position, -1 for T roots
    # --- host-side output maps
    lam_src: np.ndarray  # (B,) index into [flat local (D*B_sub) | T (Tn)]
    edge_flat: np.ndarray  # (E,) row of public edge e in the (D*E_loc) layout


ROW_FIELDS = ("h", "s_is_bif", "t_is_bif", "tT_idx", "sT_idx", "pT_idx", "root_T")


def plan_sharded_blocked(asm, D: int, max_T: int = 4096) -> ShardedBlockedPlan | None:
    """Build the plan, or None when the topology/device count does not
    admit identically-shaped per-device subforests (fall back to the
    general distributed path)."""
    gp = _plan_blocked(asm)
    if gp is None:
        return None
    csr = _blocked_csr(asm)
    in_edge, out_data, out_offs, out_counts = csr
    src_bif = np.asarray(asm._edge_start_bif)
    tgt_bif = np.asarray(asm._edge_end_bif)
    E = src_bif.shape[0]
    B = asm.network.num_multipliers
    offs = gp.bif_offsets

    # cut level: shallowest level whose width is a positive multiple of D
    widths = [lv.m for lv in gp.levels]
    t = next((i for i, m in enumerate(widths) if m >= D and m % D == 0), None)
    if t is None:
        return None
    Tn = int(offs[t])
    if Tn > max_T:
        return None
    c = widths[t] // D

    # T numbering follows the global blocked bifurcation order
    T_ids = gp.bif_order[:Tn]
    tidx = np.full(B, Tn, np.int64)
    tidx[T_ids] = np.arange(Tn)
    inT = np.zeros(B, dtype=bool)
    inT[T_ids] = True
    T_parent = np.full(Tn, -1, np.int64)
    if Tn:
        par = src_bif[in_edge[T_ids]]
        has = par >= 0
        T_parent[has] = tidx[par[has]]

    # per-device walks from the chunk-root slices of the global level-t order
    level_t_bifs = gp.bif_order[offs[t] : offs[t + 1]]
    local_plan = None
    bif_rows = []
    edge_rows_sub = []
    for d in range(D):
        roots_d = level_t_bifs[d * c : (d + 1) * c]
        walk = _blocked_walk(roots_d, in_edge, out_data, out_offs, out_counts, tgt_bif)
        if walk is None:
            return None
        bif_order_d, edge_order_d, levels_d, offsets_d = walk
        if local_plan is None:
            local_plan = _BlockedPlan(
                bif_order=bif_order_d,
                edge_order=edge_order_d,
                n_roots=int(c),
                levels=levels_d,
                bif_offsets=offsets_d,
                s_is_bif=src_bif[edge_order_d] >= 0,
                t_is_bif=tgt_bif[edge_order_d] >= 0,
            )
        elif levels_d != local_plan.levels:
            return None  # shape mismatch across devices
        bif_rows.append(bif_order_d)
        edge_rows_sub.append(edge_order_d)
    B_sub = int(bif_rows[0].size)
    E_sub = int(edge_rows_sub[0].size)

    # T edges: owner bifurcation (child side; source for boundary out-edges)
    owner = np.where(tgt_bif >= 0, tgt_bif, src_bif)
    if np.any(owner < 0):
        return None  # boundary-boundary edge (gp would have declined already)
    T_edges = np.flatnonzero(inT[owner])
    n_T = int(T_edges.size)
    T_loc = -(-n_T // D) if Tn else 0
    E_loc = E_sub + T_loc

    edge_rows = np.full((D, E_loc), -1, np.int64)
    for d in range(D):
        edge_rows[d, :E_sub] = edge_rows_sub[d]
        mine = T_edges[d::D]
        edge_rows[d, E_sub : E_sub + mine.size] = mine
    # coverage check: every edge appears exactly once
    flat = edge_rows[edge_rows >= 0]
    if flat.size != E or np.unique(flat).size != E:
        return None

    # per-row static data
    h = np.ones((D, E_loc))
    s_b = np.zeros((D, E_loc), dtype=bool)
    t_b = np.zeros((D, E_loc), dtype=bool)
    tT = np.full((D, E_loc), Tn, np.int64)
    sT = np.full((D, E_loc), Tn, np.int64)
    pT = np.full((D, E_loc), Tn, np.int64)
    lengths = np.asarray(asm.network.edge_length)
    for d in range(D):
        rows = edge_rows[d]
        valid = rows >= 0
        rv = rows[valid]
        h[d, valid] = lengths[rv]
        s_b[d, valid] = src_bif[rv] >= 0
        t_b[d, valid] = tgt_bif[rv] >= 0
        tT[d, valid] = np.where(tgt_bif[rv] >= 0, tidx[np.maximum(tgt_bif[rv], 0)], Tn)
        sT[d, valid] = np.where(src_bif[rv] >= 0, tidx[np.maximum(src_bif[rv], 0)], Tn)
        # λ→edge tail gathers must see only T endpoints on the tail rows —
        # guaranteed: tail rows are T edges, whose bif endpoints are all in T.
        # w_T pair entries: a T edge whose target AND source are T bifs is
        # the in-edge of its target (coupling to T_parent).
        both_T = (tT[d] < Tn) & (sT[d] < Tn)
        pT[d] = np.where(both_T, tT[d], Tn)

    root_T = np.full((D, c), Tn, np.int64)
    if Tn:
        for d in range(D):
            roots_d = level_t_bifs[d * c : (d + 1) * c]
            par = src_bif[in_edge[roots_d]]
            root_T[d] = np.where(par >= 0, tidx[np.maximum(par, 0)], Tn)

    # output maps
    lam_src = np.empty(B, np.int64)
    for d in range(D):
        lam_src[bif_rows[d]] = d * B_sub + np.arange(B_sub)
    lam_src[T_ids] = D * B_sub + np.arange(Tn)
    edge_flat = np.empty(E, np.int64)
    for d in range(D):
        rows = edge_rows[d]
        valid = rows >= 0
        edge_flat[rows[valid]] = d * E_loc + np.flatnonzero(valid)

    return ShardedBlockedPlan(
        D=D,
        Tn=Tn,
        E_loc=E_loc,
        E_sub=E_sub,
        B_sub=B_sub,
        c=int(c),
        local_plan=local_plan,
        edge_rows=edge_rows,
        h=h,
        s_is_bif=s_b,
        t_is_bif=t_b,
        tT_idx=tT.astype(np.int32),
        sT_idx=sT.astype(np.int32),
        pT_idx=pT.astype(np.int32),
        root_T=root_T.astype(np.int32),
        T_parent=T_parent,
        lam_src=lam_src,
        edge_flat=edge_flat,
    )


class ShardedBlockedExecutor:
    """Callable wrapper: jitted shard_map program + host-side arg/output maps.

    ``prepare_args`` permutes public-order coefficient arrays into the
    per-device row layout (host numpy, once per coefficient set) and
    device_puts them sharded; calling the executor runs the fused
    multi-device solve and returns
    ``(q_T (k·N+1, D·E_loc), p_T (N, D·E_loc), lam_loc (D·B_sub,),
    lam_T (Tn,), rhs_norm, finite)`` with the edge axis sharded."""

    def __init__(self, fn, plan: ShardedBlockedPlan, mesh, axis: str,
                 R_mode: str, f_mode: str, N: int = 1):
        self._fn = fn
        self.plan = plan
        self._mesh = mesh
        self._axis = axis
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._N = N
        self._rows_dev = None

    def _rows(self):
        if self._rows_dev is None:
            p = self.plan
            sharding = NamedSharding(self._mesh, P(self._axis))
            rows = {f: jnp.asarray(getattr(p, f)) for f in ROW_FIELDS}
            self._rows_dev = jax.device_put(rows, {f: sharding for f in rows})
        return self._rows_dev

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        p = self.plan
        rows = p.edge_rows.reshape(-1)
        valid = rows >= 0
        rv = np.maximum(rows, 0)

        def per_edge(a, mode, pad):
            a = np.asarray(a)
            if mode == "scalar":
                a = np.broadcast_to(a.reshape(-1)[:1], (p.edge_rows.size,))
                return np.where(valid, a, pad)
            if mode == "cell":
                # (C,) public cell order -> j-major (N, rows) internal
                cells = a.reshape(-1, self._N)[rv].T  # (N, rows)
                return np.where(valid[None, :], cells, pad)
            return np.where(valid, a[rv], pad)

        args = (
            per_edge(R_data, self._R_mode, 1.0),
            per_edge(f_data, self._f_mode, 0.0),
            per_edge(start_pbc, "edge", 0.0),
            per_edge(end_pbc, "edge", 0.0),
        )
        sharding = NamedSharding(self._mesh, P(self._axis))
        sharding2 = NamedSharding(self._mesh, P(None, self._axis))
        return tuple(
            jax.device_put(jnp.asarray(a), sharding2 if a.ndim == 2 else sharding)
            for a in args
        )

    def __call__(self, R_rows, f_rows, spbc_rows, epbc_rows):
        return self._fn(R_rows, f_rows, spbc_rows, epbc_rows, self._rows())


def _make_local_body(N: int, plan: ShardedBlockedPlan, axis: str, dtype,
                     k: int = 1, R_mode: str = "edge", f_mode: str = "edge"):
    """The per-device fused solve, parameterized so both the executor and
    the vmapped 2-D sweep can reuse it.  Returns ``local_solve(R_e, f_e,
    spbc, epbc, rows)`` — called INSIDE shard_map with device-local
    shards."""
    Tn, E_loc, E_sub = plan.Tn, plan.E_loc, plan.E_sub
    lp = plan.local_plan
    T_parent = plan.T_parent

    def local_solve(R_e, f_e, spbc, epbc, rows):
        def row(a):
            return a.reshape(a.shape[-1])

        h = row(rows["h"]).astype(dtype) / N
        s_b = row(rows["s_is_bif"])
        t_b = row(rows["t_is_bif"])
        tT = row(rows["tT_idx"])
        sT = row(rows["sT_idx"])
        pT = row(rows["pT_idx"])
        rTi = row(rows["root_T"])
        R_e = R_e.astype(dtype)
        f_e = f_e.astype(dtype)
        spbc = spbc.astype(dtype)
        epbc = epbc.astype(dtype)

        # closed-form condensation + back-substitution, shared with the
        # serial blocked executor (one source of truth for the formulas)
        W, g, Ftot, back = _blocked_condense(
            N, E_loc, h, R_e, f_e,
            "cell" if R_e.ndim == 2 else "edge",
            "cell" if f_e.ndim == 2 else "edge",
            k=k,
        )
        w = 1.0 / W
        const = (-spbc * (~s_b) + epbc * (~t_b) - g) * w
        cF = const + Ftot

        # local blocked forward elimination (slices touch only [0, E_sub))
        d0, r0, w0, saved, rhs_sq = _blocked_forward(lp, w, const, Ftot)

        if Tn > 0:
            # T system from device-local contributions + one psum
            dT = jnp.zeros(Tn, dtype)
            rT = jnp.zeros(Tn, dtype)
            dT = dT.at[tT].add(w, mode="drop")
            rT = rT.at[tT].add(cF, mode="drop")
            dT = dT.at[sT].add(w, mode="drop")
            rT = rT.at[sT].add(-const, mode="drop")
            wT = jnp.zeros(Tn, dtype).at[pT].add(w, mode="drop")
            # chunk roots eliminate INTO their T parents
            factor0 = w0 / d0
            dT = dT.at[rTi].add(-w0 * factor0, mode="drop")
            rT = rT.at[rTi].add(factor0 * r0, mode="drop")
            dT = jax.lax.psum(dT, axis)
            rT = jax.lax.psum(rT, axis)
            wT = jax.lax.psum(wT, axis)
            # replicated dense solve of the (tiny) T forest Laplacian
            tp = jnp.asarray(T_parent)
            has_p = tp >= 0
            tps = jnp.where(has_p, tp, 0)
            LT = jnp.zeros((Tn, Tn), dtype)
            LT = LT.at[jnp.arange(Tn), jnp.arange(Tn)].add(dT)
            wTp = jnp.where(has_p, wT, 0.0)
            LT = LT.at[jnp.arange(Tn), tps].add(-wTp)
            LT = LT.at[tps, jnp.arange(Tn)].add(-wTp)
            scale = jnp.sqrt(jnp.diagonal(LT))
            LTs = (LT / scale[:, None]) / scale[None, :]
            chol = jnp.linalg.cholesky(LTs)
            lam_T = jax.scipy.linalg.cho_solve((chol, True), rT / scale) / scale
            lam_T_pad = jnp.concatenate([lam_T, jnp.zeros(1, dtype)])
            lam_root_src = lam_T_pad[rTi]
            lam0 = (r0 + w0 * lam_root_src) / d0
            rhs_sq = jax.lax.psum(rhs_sq, axis)
            rhs_norm = jnp.sqrt(rhs_sq + jnp.sum(rT * rT))
        else:
            lam_T = jnp.zeros(0, dtype)
            lam_T_pad = jnp.zeros(1, dtype)
            lam_root_src = None
            lam0 = r0 / d0
            rhs_norm = jnp.sqrt(jax.lax.psum(rhs_sq, axis))

        lam_lev, lam_loc = _blocked_backward(lp, saved, lam0)

        # per-edge λ endpoints: local rows from the level pieces
        # (slices/concats), tail (T + pad) rows from the replicated λ_T
        lam_s_loc, lam_t_loc = _blocked_lambda_to_edges(
            lp, lam_lev, dtype, lam_root_src=lam_root_src
        )
        tail = slice(E_sub, E_loc)
        lam_s = jnp.concatenate([lam_s_loc, lam_T_pad[jnp.minimum(sT[tail], Tn)]])
        lam_t = jnp.concatenate([lam_t_loc, lam_T_pad[jnp.minimum(tT[tail], Tn)]])

        r0_e = jnp.where(s_b, lam_s, -spbc)
        rN_e = jnp.where(t_b, -lam_t, epbc)
        q0 = (r0_e + rN_e - g) * w
        q_T, p_T = back(q0, r0_e)
        # finiteness from the (E_loc,)-sized precursors (q_T/p_T are
        # affine in them — see _blocked_uniform_solve), not the big blocks
        finite = (
            jnp.all(jnp.isfinite(q0))
            & jnp.all(jnp.isfinite(r0_e))
            & jnp.all(jnp.isfinite(lam_loc))
            & jnp.all(jnp.isfinite(lam_T))
            & jnp.all(jnp.isfinite(W))
            & jnp.all(jnp.isfinite(g))
            & jnp.all(jnp.isfinite(Ftot))
        )
        finite = jax.lax.pmin(finite.astype(jnp.int32), axis) > 0
        return q_T, p_T, lam_loc, lam_T, rhs_norm, finite

    return local_solve


def build_sharded_blocked_executor(
    asm,
    plan: ShardedBlockedPlan,
    mesh,
    axis: str,
    dtype=jnp.float64,
    modes: tuple | None = None,
) -> ShardedBlockedExecutor:
    """Trace + jit the shard_map pipeline for a prepared plan.

    ``modes`` overrides the live ``asm.coefficient_modes()`` — the caller
    may be serving an assemble-time coefficient snapshot whose kinds no
    longer match the assembler's current forms.
    """
    R_mode, f_mode, _ = modes if modes is not None else asm.coefficient_modes()
    if R_mode not in ("scalar", "edge", "cell") or f_mode not in (
        "scalar", "edge", "cell"
    ):
        raise ValueError(
            "sharded blocked executor requires per-edge or per-cell coefficients"
        )
    local_solve = _make_local_body(
        asm.network.N, plan, axis, dtype, k=asm.flux_degree,
        R_mode=R_mode, f_mode=f_mode,
    )

    spec_e = P(axis)
    spec_c = P(None, axis)  # j-major (N, E) per-cell coefficient rows
    in_specs = (
        spec_c if R_mode == "cell" else spec_e,
        spec_c if f_mode == "cell" else spec_e,
        spec_e, spec_e,
        {f: spec_e for f in ROW_FIELDS},
    )
    # λ_T / scalars are replicated by construction (psum-reduced inputs +
    # identical replicated solve); the static vma checker cannot see
    # through the scatter/cholesky chain, so replication is pinned
    # numerically by tests/test_sharding.py instead.
    out_specs = (
        P(None, axis), P(None, axis), spec_e, P(), P(), P(),
    )
    fn = shard_map(
        local_solve, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return ShardedBlockedExecutor(
        jax.jit(fn), plan, mesh, axis, R_mode, f_mode, N=asm.network.N
    )


def sharded_blocked_sweep(
    asm,
    plan: ShardedBlockedPlan,
    R: "np.ndarray",
    mesh2d,
    batch_axis: str = "batch",
    edge_axis: str = "edges",
    dtype=jnp.float64,
):
    """2-D (scenarios × edges) sweep through the blocked elimination.

    The scenario axis is data-parallel over ``batch_axis`` devices while
    within each batch group the edge axis runs the blocked sharded
    elimination over ``edge_axis`` devices — ``vmap`` of the per-device
    body (measured on hardware: vmap does not degrade the blocked
    layout).  This replaces the dense per-scenario Cholesky of the
    legacy path, whose O(B²) memory made large-network sweeps
    infeasible.  Only the resistance varies per scenario; f and the
    boundary pressures are those of the assembler's computed forms.

    Returns ``(x, (inputs, outputs))``: ``x (S, num_dofs)`` host array in
    the public layout, and the program's sharded device arrays.
    """
    R_mode, f_mode, _ = asm.coefficient_modes()
    if R_mode != "edge":
        raise ValueError("sharded_blocked_sweep requires per-edge R in compute_forms")
    if f_mode not in ("scalar", "edge"):
        raise ValueError("sharded_blocked_sweep requires per-edge (or scalar) f")
    Db = mesh2d.shape[batch_axis]
    De = mesh2d.shape[edge_axis]
    assert De * plan.E_loc == plan.edge_rows.size

    R = np.asarray(R, dtype=np.float64)
    if R.ndim != 2 or R.shape[1] != asm.network.num_edges:
        raise ValueError(
            f"R must be (num_scenarios, num_edges) = (S, "
            f"{asm.network.num_edges}); got {R.shape}"
        )
    S, E = R.shape
    S_pad = (-S) % Db

    # per-row arg layout for every scenario (pad rows R=1) + pad scenarios
    rows = plan.edge_rows.reshape(-1)
    valid = rows >= 0
    rv = np.maximum(rows, 0)
    R_rows = np.where(valid[None, :], R[:, rv], 1.0)
    if S_pad:
        R_rows = np.concatenate([R_rows, np.ones((S_pad, rows.size))], axis=0)

    def fixed(a, mode, pad):
        a = np.asarray(a)
        if mode == "scalar":
            a = np.broadcast_to(a.reshape(-1)[:1], (rows.size,))
            return np.where(valid, a, pad)
        return np.where(valid, a[rv], pad)

    f_rows = jnp.asarray(fixed(asm._f_data, f_mode, 0.0))
    spbc_rows = jnp.asarray(fixed(asm._edge_start_pbc, "edge", 0.0))
    epbc_rows = jnp.asarray(fixed(asm._edge_end_pbc, "edge", 0.0))
    rows_dev = {f: jnp.asarray(getattr(plan, f)) for f in ROW_FIELDS}

    body = _make_local_body(asm.network.N, plan, edge_axis, dtype, k=asm.flux_degree)

    def local(R_chunk, f_e, spbc, epbc, rows_d):
        # R_chunk: (S_loc, E_loc) — vmap the per-device solve over the
        # local scenario chunk; the edge-axis psums batch naturally.
        return jax.vmap(
            lambda R_e: body(R_e, f_e, spbc, epbc, rows_d)
        )(R_chunk)

    spec_R = P(batch_axis, edge_axis)
    spec_e = P(edge_axis)
    in_specs = (
        spec_R, spec_e, spec_e, spec_e,
        {f: spec_e for f in ROW_FIELDS},
    )
    out_specs = (
        P(batch_axis, None, edge_axis),  # q_T (S, k*N+1, D_e*E_loc)
        P(batch_axis, None, edge_axis),  # p_T
        P(batch_axis, edge_axis),  # lam_loc (S, D_e*B_sub)
        P(batch_axis),  # lam_T (S, Tn) — replicated over edges
        P(batch_axis),  # rhs_norm
        P(batch_axis),  # finite
    )
    fn = jax.jit(shard_map(
        local, mesh=mesh2d, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    ))
    sharding_R = NamedSharding(mesh2d, spec_R)
    sharding_e = NamedSharding(mesh2d, spec_e)
    ins = (
        jax.device_put(jnp.asarray(R_rows), sharding_R),
        jax.device_put(f_rows, sharding_e),
        jax.device_put(spbc_rows, sharding_e),
        jax.device_put(epbc_rows, sharding_e),
        jax.device_put(rows_dev, {f: sharding_e for f in rows_dev}),
    )
    outs = fn(*ins)
    q_T, p_T, lam_loc, lam_T, _rhs, finite = outs
    if not bool(np.all(np.asarray(finite))):
        raise RuntimeError(
            "Solver did not converge: sharded blocked sweep produced "
            "non-finite values"
        )

    # host flatten per scenario: internal rows -> public layout
    q = np.swapaxes(np.asarray(q_T), 1, 2)[:S]  # (S, D_e*E_loc, k*N+1)
    p = np.swapaxes(np.asarray(p_T), 1, 2)[:S]
    q_edge = q[:, plan.edge_flat]  # (S, E, k*N+1)
    p_cells = p[:, plan.edge_flat]
    lam_flat = np.concatenate([np.asarray(lam_loc), np.asarray(lam_T)], axis=1)[:S]
    lam = lam_flat[:, plan.lam_src]

    from .sharding import _scatter_blocks_to_x

    return _scatter_blocks_to_x(asm, q_edge, p_cells, lam), (ins, outs)
