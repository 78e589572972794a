"""Distributed (multiplier-sharded) exact tree elimination.

Round-1's sharded solver psum-reduced the bifurcation Schur system and ran
the λ elimination REPLICATED on every device — O(B) memory and work per
chip, which caps scaling exactly at the BASELINE north-star sizes (n=20
trees have B = 524,287 multipliers).  This module distributes the λ stage
itself, the analog of MUMPS's multifrontal parallel elimination
over MPI ranks (reference ``solver.py:58-65``):

* the bifurcation forest is partitioned on the host into ``D`` bins of
  complete subtrees (maximal subtrees of at most ``ceil(B/D)`` nodes,
  LPT-packed by owned-edge count), plus a small replicated top ``T`` (the
  ancestors whose subtrees exceed the target — size O(D · depth) for bushy
  networks);
* graph edges are re-partitioned to FOLLOW the node partition (the edge
  whose child-side bifurcation lives in chunk c is owned by c's bin), so
  every Schur contribution of a device's edges lands either on its own
  nodes or on ``T`` — cross-device traffic is one psum of the tiny
  ``T``-system per solve, not O(B);
* each device forward-eliminates its local forest bottom-up with the same
  scatter-free level-ordered kernel as the serial path (sorted segment
  sums over uniform padded level slices), its chunk roots eliminating INTO
  the psum-reduced ``T`` system; ``T`` is solved densely (replicated,
  ~D×D) and back-substitution runs root-down, purely locally.

Per-device λ-stage memory drops from ~4 B-sized replicated arrays to
B/D (+ the T system), with identical exact arithmetic — sharded == serial
is pinned to 1e-10 at n=18 scale in ``tests/test_sharding.py``.
"""

from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["DistTreePlan", "plan_distributed_tree", "local_eliminate"]


class DistTreePlan(typing.NamedTuple):
    """Host-built static plan for the distributed λ elimination.

    Arrays with a leading ``D`` axis are sharded over the device mesh (each
    device receives its row); the rest are identical (baked) constants.
    Every per-device array is padded to uniform shape so ``shard_map``
    traces a single program.
    """

    D: int
    B: int  # true multiplier count
    B_loc: int  # padded per-device local node count
    Tn: int  # replicated top-tree size
    level_offsets: np.ndarray  # (L+1,) uniform local level slice bounds
    # --- edge partition
    edge_perm: np.ndarray  # (D, E_loc) index into the PADDED edge arrays
    e_start_loc: np.ndarray  # (D, E_loc) remapped start_bif: local pos,
    #     B_loc + t for T nodes, -1 for boundary/pad
    e_end_loc: np.ndarray  # (D, E_loc)
    # --- local diag/rhs assembly (gather-fold reductions)
    t_sel: np.ndarray  # (D, S_t) local edge index of end-bif contributions
    t_fold: np.ndarray  # (D, B_loc, K) gather-fold into the sel stream
    t_mask: np.ndarray  # (D, S_t) 1.0 valid / 0.0 pad
    s_sel: np.ndarray  # (D, S_s) start-bif contributions
    s_fold: np.ndarray
    s_mask: np.ndarray
    w_sel: np.ndarray  # (D, S_w) pair edges, folded onto the child node
    w_fold: np.ndarray
    w_mask: np.ndarray
    # --- direct-to-T contributions (edges touching T nodes)
    tT_sel: np.ndarray  # (D, S_T) end-bif in T
    tT_fold: np.ndarray  # (D, Tn, K)
    tT_mask: np.ndarray
    sT_sel: np.ndarray  # (D, S_T2) start-bif in T
    sT_fold: np.ndarray
    sT_mask: np.ndarray
    wT_sel: np.ndarray  # (D, S_WT) T-T pair edges, child T index
    wT_fold: np.ndarray
    wT_mask: np.ndarray
    # --- per-level child->parent fold (tuple over levels 1..L-1, each
    #     (D, npar, K) indices into the level's child slice; n = pad)
    level_folds: tuple
    # --- local elimination structure
    parent_pos: np.ndarray  # (D, B_loc) local parent position (self-pos for
    #     level-0 / pads; unused there)
    root_T_idx: np.ndarray  # (D, W0) T index of each level-0 node's parent
    #     (Tn for global roots / pads)
    # --- replicated T elimination (dense)
    T_parent: np.ndarray  # (Tn,) parent T index (-1 roots)
    # --- output mapping (host side)
    lam_src: np.ndarray  # (B,) index into [flat local (D*B_loc) | T (Tn)]
    edge_inv: np.ndarray  # (E,) position of original edge e in the flat
    #     (D*E_loc) reordered layout


def _bif_forest(B: int, pairs: np.ndarray):
    """Rooted forest over the bifurcation pair graph: (depth, parent,
    parent_pair).  Roots = minimum-id node per component."""
    P = pairs.shape[0]
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, connected_components

    depth = np.full(B, -1, np.int64)
    parent = np.full(B, -1, np.int64)
    if P == 0:
        return np.zeros(B, np.int64), parent

    adjm = sp.csr_matrix(
        (np.ones(2 * P), (np.r_[pairs[:, 0], pairs[:, 1]], np.r_[pairs[:, 1], pairs[:, 0]])),
        shape=(B, B),
    )
    n_comp, labels = connected_components(adjm, directed=False)
    _, roots = np.unique(labels, return_index=True)
    for r in roots:
        order, preds = breadth_first_order(adjm, int(r), directed=False, return_predecessors=True)
        parent[order] = preds[order]
        parent[int(r)] = -1
        # depth via BFS order: parents appear before children
        depth[int(r)] = 0
        for v in order[1:]:
            depth[v] = depth[parent[v]] + 1
    return depth, parent


def plan_distributed_tree(
    asm, tree_plan, D: int, max_T: int = 4096
) -> DistTreePlan | None:
    """Build the distributed elimination plan, or None when unsupported
    (cycle cores, or a top tree too large — e.g. chain-like networks where
    the subtree partition degenerates)."""
    mesh = asm.network
    B = mesh.num_multipliers
    if B == 0 or tree_plan is None or tree_plan.core_size > 0:
        return None
    pairs = np.asarray(tree_plan.pair_nodes)
    depth, parent = _bif_forest(B, pairs)

    # subtree sizes, bottom-up by level
    size = np.ones(B, np.int64)
    max_depth = int(depth.max()) if B else 0
    for d in range(max_depth, 0, -1):
        nodes = np.flatnonzero(depth == d)
        np.add.at(size, parent[nodes], size[nodes])

    target = -(-B // D)  # ceil
    inT = size > target
    if np.count_nonzero(inT) > max_T:
        return None
    T_nodes = np.flatnonzero(inT)
    Tn = int(T_nodes.size)
    tidx = np.full(B, -1, np.int64)
    tidx[T_nodes] = np.arange(Tn)
    T_parent = np.full(Tn, -1, np.int64)
    has_par = parent[T_nodes] >= 0
    T_parent[has_par] = tidx[parent[T_nodes[has_par]]]
    assert np.all((parent[T_nodes[has_par]] < 0) | inT[parent[T_nodes[has_par]]])

    # chunks: maximal subtrees below T
    par_safe = np.where(parent >= 0, parent, 0)
    is_chunk_root = (~inT) & ((parent < 0) | inT[par_safe])
    chunk_roots = np.flatnonzero(is_chunk_root)
    n_chunks = int(chunk_roots.size)
    chunk_of = np.full(B, -1, np.int64)
    chunk_of[chunk_roots] = np.arange(n_chunks)
    for d in range(1, max_depth + 1):
        nodes = np.flatnonzero((depth == d) & ~inT & ~is_chunk_root)
        chunk_of[nodes] = chunk_of[parent[nodes]]

    # --- edge ownership: child-side bifurcation decides
    s_bif = np.asarray(asm._edge_start_bif, np.int64)
    t_bif = np.asarray(asm._edge_end_bif, np.int64)
    E = s_bif.shape[0]
    both = (s_bif >= 0) & (t_bif >= 0)
    sd = np.where(s_bif >= 0, depth[np.where(s_bif >= 0, s_bif, 0)], -1)
    td = np.where(t_bif >= 0, depth[np.where(t_bif >= 0, t_bif, 0)], -1)
    child_bif = np.where(both, np.where(sd > td, s_bif, t_bif),
                         np.where(s_bif >= 0, s_bif, t_bif))  # -1 if no bifs
    own_chunk = np.where(child_bif >= 0, chunk_of[np.where(child_bif >= 0, child_bif, 0)], -1)

    # chunk weights = owned edge count; LPT pack into D bins
    weights = np.bincount(own_chunk[own_chunk >= 0], minlength=n_chunks)
    bin_of_chunk = np.zeros(n_chunks, np.int64)
    loads = np.zeros(D, np.int64)
    for c in np.argsort(weights)[::-1]:
        k = int(np.argmin(loads))
        bin_of_chunk[c] = k
        loads[k] += weights[c]
    edge_dev = np.where(own_chunk >= 0, bin_of_chunk[np.where(own_chunk >= 0, own_chunk, 0)], -1)
    # free edges (T-T / boundary-boundary): balance the remainder
    free = np.flatnonzero(edge_dev < 0)
    for e in free:
        k = int(np.argmin(loads))
        edge_dev[e] = k
        loads[k] += 1

    E_loc = int(np.max(np.bincount(edge_dev, minlength=D)))
    # edge_perm rows index into the PADDED edge array; pad slot = E (one
    # inert edge appended by the caller)
    edge_perm = np.full((D, E_loc), E, np.int64)
    local_edge_of = np.full(E, -1, np.int64)
    for k in range(D):
        mine = np.flatnonzero(edge_dev == k)
        edge_perm[k, : mine.size] = mine
        local_edge_of[mine] = np.arange(mine.size)
    edge_inv = np.empty(E, np.int64)
    edge_inv = edge_dev * E_loc + local_edge_of

    # --- local node layout: levels padded to cross-device maxima
    node_dev = np.full(B, -1, np.int64)
    sel_nodes = ~inT
    node_dev[sel_nodes] = bin_of_chunk[chunk_of[sel_nodes]]
    depth_local = np.full(B, -1, np.int64)
    root_depth_of_chunk = depth[chunk_roots]
    depth_local[sel_nodes] = depth[sel_nodes] - root_depth_of_chunk[chunk_of[sel_nodes]]
    L = int(depth_local.max()) + 1 if np.any(sel_nodes) else 1

    lvl_w = np.zeros(L, np.int64)
    for lev in range(L):
        at = depth_local == lev
        if np.any(at):
            lvl_w[lev] = np.max(np.bincount(node_dev[at], minlength=D))
    lvl_w = np.maximum(lvl_w, 1)  # avoid zero-width slices
    level_offsets = np.concatenate([[0], np.cumsum(lvl_w)])
    B_loc = int(level_offsets[-1])

    pos_local = np.full(B, -1, np.int64)  # position within the device layout
    parent_pos = np.tile(np.arange(B_loc, dtype=np.int64), (D, 1))  # self for pads
    for lev in range(L):
        off = int(level_offsets[lev])
        for k in range(D):
            nodes = np.flatnonzero((depth_local == lev) & (node_dev == k))
            if lev > 0 and nodes.size:
                nodes = nodes[np.argsort(pos_local[parent[nodes]], kind="stable")]
            pos_local[nodes] = off + np.arange(nodes.size)
            if lev > 0 and nodes.size:
                parent_pos[k, off : off + nodes.size] = pos_local[parent[nodes]]
                # pads point at the LAST real parent to keep segments sorted
                if nodes.size < lvl_w[lev]:
                    parent_pos[k, off + nodes.size : off + int(lvl_w[lev])] = (
                        pos_local[parent[nodes]][-1]
                    )
            elif lev > 0:
                # whole level is padding on this device: any valid slot
                parent_pos[k, off : off + int(lvl_w[lev])] = int(level_offsets[lev - 1])

    # per-level child->parent gather folds (pads excluded: folds PULL only
    # real children, so padding slots are simply never read)
    level_folds = []
    for lev in range(1, L):
        o, op = int(level_offsets[lev]), int(level_offsets[lev - 1])
        n, npar = int(lvl_w[lev]), int(lvl_w[lev - 1])
        counts = np.zeros((D, npar), np.int64)
        segs_k = []
        for k in range(D):
            real = np.flatnonzero((depth_local == lev) & (node_dev == k))
            seg = np.sort(parent_pos[k, o : o + real.size] - op)
            segs_k.append(seg)
            if real.size:
                counts[k] = np.bincount(seg, minlength=npar)
        K = max(1, int(counts.max()))
        fold = np.full((D, npar, K), n, np.int64)  # n = zero-pad slot
        for k in range(D):
            offs_ = np.concatenate([[0], np.cumsum(counts[k])])
            idx = offs_[:-1, None] + np.arange(K)[None, :]
            valid = np.arange(K)[None, :] < counts[k][:, None]
            fold[k] = np.where(valid, idx, n)
        level_folds.append(fold)

    W0 = int(lvl_w[0])
    root_T_idx = np.full((D, W0), Tn, np.int64)
    for k in range(D):
        roots_k = np.flatnonzero(is_chunk_root & (node_dev == k))
        roots_k = roots_k[np.argsort(pos_local[roots_k])]
        pp = parent[roots_k]
        root_T_idx[k, pos_local[roots_k]] = np.where(pp >= 0, tidx[np.where(pp >= 0, pp, 0)], Tn)

    # --- sorted segment-sum plans -------------------------------------
    def seg_plan(edge_ids: np.ndarray, targets: np.ndarray, width: int):
        """Per-device (sel into local edges, mask, gather-fold idx) stacks.

        The reduction is expressed as a PULL (each target gathers its
        boundedly-many contributions) in a fixed summation order instead
        of a scatter-add; pad slots point past the valid stream."""
        sels, segs = [], []
        for k in range(D):
            mine = edge_dev[edge_ids] == k
            eid = edge_ids[mine]
            tgt = targets[mine]
            order = np.argsort(tgt, kind="stable")
            sels.append(local_edge_of[eid][order])
            segs.append(tgt[order])
        S = max((len(s) for s in sels), default=0)
        S = max(S, 1)
        sel = np.zeros((D, S), np.int64)
        mask = np.zeros((D, S))
        if width == 0:  # e.g. no top tree (Tn = 0)
            return sel, np.zeros((D, 0, 1), np.int64), mask  # (sel, fold, mask)
        counts = np.zeros((D, width), np.int64)
        for k in range(D):
            n = len(sels[k])
            sel[k, :n] = sels[k]
            mask[k, :n] = 1.0
            if n:
                counts[k] = np.bincount(segs[k], minlength=width)
        K = max(1, int(counts.max()))
        fold = np.full((D, width, K), S, np.int64)  # S = zero-pad slot
        for k in range(D):
            offs_ = np.concatenate([[0], np.cumsum(counts[k])])
            idx = offs_[:-1, None] + np.arange(K)[None, :]
            valid = np.arange(K)[None, :] < counts[k][:, None]
            fold[k] = np.where(valid, idx, S)
        return sel, fold, mask

    # end-bif contributions (w to diag, const+Ftot to rhs)
    t_edges = np.flatnonzero(t_bif >= 0)
    t_local = t_edges[~inT[t_bif[t_edges]]]
    t_inT = t_edges[inT[t_bif[t_edges]]]
    t_sel, t_fold, t_mask = seg_plan(t_local, pos_local[t_bif[t_local]], B_loc)
    tT_sel, tT_fold, tT_mask = seg_plan(t_inT, tidx[t_bif[t_inT]], Tn)
    # start-bif contributions
    s_edges = np.flatnonzero(s_bif >= 0)
    s_local = s_edges[~inT[s_bif[s_edges]]]
    s_inT = s_edges[inT[s_bif[s_edges]]]
    s_sel, s_fold, s_mask = seg_plan(s_local, pos_local[s_bif[s_local]], B_loc)
    sT_sel, sT_fold, sT_mask = seg_plan(s_inT, tidx[s_bif[s_inT]], Tn)
    # pair conductances: child side decides the segment
    pair_edges = np.flatnonzero(both)
    pc = child_bif[pair_edges]
    pw_local = pair_edges[~inT[pc]]
    pw_T = pair_edges[inT[pc]]
    w_sel, w_fold, w_mask = seg_plan(pw_local, pos_local[child_bif[pw_local]], B_loc)
    wT_sel, wT_fold, wT_mask = seg_plan(pw_T, tidx[child_bif[pw_T]], Tn)

    # --- per-edge remapped bif indices (into [local B_loc | T Tn | -1])
    def remap(bifs: np.ndarray) -> np.ndarray:
        out = np.full(E + 1, -1, np.int64)  # +1: the inert pad edge
        valid = bifs >= 0
        vb = bifs[valid]
        out[:E][valid] = np.where(inT[vb], B_loc + tidx[vb], pos_local[vb])
        return out

    rs = remap(s_bif)
    rt = remap(t_bif)
    e_start_loc = rs[edge_perm]
    e_end_loc = rt[edge_perm]

    # --- output λ gather
    lam_src = np.empty(B, np.int64)
    lam_src[sel_nodes] = node_dev[sel_nodes] * B_loc + pos_local[sel_nodes]
    lam_src[inT] = D * B_loc + tidx[inT]

    return DistTreePlan(
        D=D,
        B=B,
        B_loc=B_loc,
        Tn=Tn,
        level_offsets=level_offsets,
        edge_perm=edge_perm,
        e_start_loc=e_start_loc,
        e_end_loc=e_end_loc,
        t_sel=t_sel, t_fold=t_fold, t_mask=t_mask,
        s_sel=s_sel, s_fold=s_fold, s_mask=s_mask,
        w_sel=w_sel, w_fold=w_fold, w_mask=w_mask,
        tT_sel=tT_sel, tT_fold=tT_fold, tT_mask=tT_mask,
        sT_sel=sT_sel, sT_fold=sT_fold, sT_mask=sT_mask,
        wT_sel=wT_sel, wT_fold=wT_fold, wT_mask=wT_mask,
        level_folds=tuple(level_folds),
        parent_pos=parent_pos,
        root_T_idx=root_T_idx,
        T_parent=T_parent,
        lam_src=lam_src,
        edge_inv=edge_inv,
    )


# plan fields with a leading device axis, shipped as sharded shard_map
# operands (everything else is baked into the traced program as constants)
ROW_FIELDS = (
    "t_sel", "t_fold", "t_mask", "s_sel", "s_fold", "s_mask",
    "w_sel", "w_fold", "w_mask", "tT_sel", "tT_fold", "tT_mask",
    "sT_sel", "sT_fold", "sT_mask", "wT_sel", "wT_fold", "wT_mask",
    "parent_pos", "root_T_idx",
)


def plan_rows(plan: DistTreePlan) -> dict:
    """The per-device plan arrays as a dict pytree for shard_map."""
    rows = {f: jnp.asarray(getattr(plan, f)) for f in ROW_FIELDS}
    for i, fold in enumerate(plan.level_folds):
        rows[f"lvlfold_{i}"] = jnp.asarray(fold)
    return rows


def local_eliminate(plan: DistTreePlan, rows: dict, ed, axis: str):
    """Device-local program: assemble local/T Schur contributions from the
    owned edge shard, eliminate the local forest bottom-up, psum + solve the
    tiny T system, back-substitute.  Returns λ over [local B_loc | T Tn]
    (local shard + replicated T) ready for :func:`_backsub_from_lambda`
    with the plan's remapped per-edge indices.

    Called INSIDE shard_map: ``ed`` and the (1, ...) plan rows are the
    device-local shards."""
    dt = ed.W.dtype
    B_loc, Tn = plan.B_loc, plan.Tn
    offs = plan.level_offsets
    L = len(offs) - 1

    def row(a):  # (1, S) sharded plan row -> (S,)
        return a.reshape(a.shape[-1])

    w_edges = 1.0 / ed.W
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    const = (-ed.start_pbc * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
    Ftot = ed.cumF[:, -1]

    def reduce_local(vals, name):
        # pull-style reduction: each target gathers its contributions
        # through the host-built fold (fixed order, no scatter); the
        # fold's pad entries point at the appended zero.
        # ``vals`` may be (n,) or (n, C) — channels sharing the layout
        # reduce through one gather.
        mask = row(rows[f"{name}_mask"])
        if vals.ndim > 1:
            mask = mask[:, None]
        picked = vals[row(rows[f"{name}_sel"])] * mask
        pad = jnp.zeros((1,) + picked.shape[1:], dtype=picked.dtype)
        vp = jnp.concatenate([picked, pad])
        fold = rows[f"{name}_fold"]
        return jnp.sum(vp[fold.reshape(fold.shape[-2], fold.shape[-1])], axis=1)

    dr_t = reduce_local(jnp.stack([w_edges, const + Ftot], axis=-1), "t")
    dr_s = reduce_local(jnp.stack([w_edges, -const], axis=-1), "s")
    d = dr_t[:, 0] + dr_s[:, 0]
    r = dr_t[:, 1] + dr_s[:, 1]
    w_node = reduce_local(w_edges, "w")
    # padded slots: inert (d=1 so divisions are safe, w=0, r=0)
    d = jnp.where(d == 0.0, 1.0, d)

    drT_t = reduce_local(jnp.stack([w_edges, const + Ftot], axis=-1), "tT")
    drT_s = reduce_local(jnp.stack([w_edges, -const], axis=-1), "sT")
    dT_part = drT_t[:, 0] + drT_s[:, 0]
    rT_part = drT_t[:, 1] + drT_s[:, 1]
    wT_part = reduce_local(w_edges, "wT")

    par = row(rows["parent_pos"])

    # forward elimination: deepest local level first
    saved = []
    for lev in range(L - 1, 0, -1):
        o, o1 = int(offs[lev]), int(offs[lev + 1])
        op, op1 = int(offs[lev - 1]), int(offs[lev])
        n, npar = o1 - o, op1 - op
        db = jax.lax.dynamic_slice(d, (o,), (n,))
        rb = jax.lax.dynamic_slice(r, (o,), (n,))
        wb = jax.lax.dynamic_slice(w_node, (o,), (n,))
        fold = rows[f"lvlfold_{lev - 1}"]
        fold = fold.reshape(fold.shape[-2], fold.shape[-1])  # (npar, K)
        factor = wb / db
        both = jnp.concatenate(
            [jnp.stack([-wb * factor, factor * rb], axis=-1), jnp.zeros((1, 2), dt)]
        )
        upd = jnp.sum(both[fold], axis=1)
        d_upd, r_upd = upd[:, 0], upd[:, 1]
        d = jax.lax.dynamic_update_slice(
            d, jax.lax.dynamic_slice(d, (op,), (npar,)) + d_upd, (op,)
        )
        r = jax.lax.dynamic_update_slice(
            r, jax.lax.dynamic_slice(r, (op,), (npar,)) + r_upd, (op,)
        )
        saved.append((o, n, db, rb, wb))

    # chunk roots (local level 0) eliminate INTO the T system
    W0 = int(offs[1])
    d0 = d[:W0]
    r0 = r[:W0]
    w0 = w_node[:W0]
    rTi = row(rows["root_T_idx"])
    factor0 = w0 / d0
    dT_part = dT_part.at[rTi].add(-w0 * factor0, mode="drop")
    rT_part = rT_part.at[rTi].add(factor0 * r0, mode="drop")

    if Tn > 0:
        dT = jax.lax.psum(dT_part, axis)
        rT = jax.lax.psum(rT_part, axis)
        wT = jax.lax.psum(wT_part, axis)
        # dense replicated solve of the T forest Laplacian (Tn ~ O(D))
        tp = jnp.asarray(plan.T_parent)
        has_p = tp >= 0
        tps = jnp.where(has_p, tp, 0)
        LT = jnp.zeros((Tn, Tn), dtype=dt)
        LT = LT.at[jnp.arange(Tn), jnp.arange(Tn)].add(dT)
        wTp = jnp.where(has_p, wT, 0.0)
        LT = LT.at[jnp.arange(Tn), tps].add(-wTp)
        LT = LT.at[tps, jnp.arange(Tn)].add(-wTp)
        scale = jnp.sqrt(jnp.diagonal(LT))
        LTs = (LT / scale[:, None]) / scale[None, :]
        chol = jnp.linalg.cholesky(LTs)
        lam_T = (
            jax.scipy.linalg.cho_solve((chol, True), rT / scale) / scale
        )
    else:
        lam_T = jnp.zeros(0, dtype=dt)

    # back-substitution: chunk roots from T parents, then levels down
    lam_T_pad = jnp.concatenate([lam_T, jnp.zeros(1, dtype=dt)])
    lam = jnp.zeros(B_loc, dtype=dt)
    lam = lam.at[jnp.arange(W0)].set((r0 + w0 * lam_T_pad[rTi]) / d0)
    for o, n, db, rb, wb in reversed(saved):
        lam_par = lam[jax.lax.dynamic_slice(par, (o,), (n,))]
        lam = jax.lax.dynamic_update_slice(lam, (rb + wb * lam_par) / db, (o,))

    return jnp.concatenate([lam, lam_T])
