"""Tree supernodal multifrontal elimination of cyclic bifurcation cores.

The rounds-based sparse elimination (:mod:`.core_elim`) is gather/fold
bound: a 320² per-edge-R lattice costs 36 unrolled rounds carrying ~52M
gather/fold elements plus a CHAIN of 11 sequential dense fronts, and its
HLO takes minutes to compile.  This module is the replacement for large
cores — the full multifrontal method of sparse direct solvers (MUMPS' own
structure, reference ``solver.py:62``), organised around the
nested-dissection separator TREE so the work is dense, batched ops
instead of sparse index traffic.

Design rules:

* **f32 factor, f64 refinement.**  Each batched front group is factored
  in **f32** into an explicit inverse triangular factor
  (:func:`chol_inverse_batched`: stock batched Cholesky, then a batched
  triangular solve against I), and the final f64 accuracy is recovered
  with **iterative refinement** against the exact f64 core operator.
  (Chosen on earlier hardware where f64 factorization was emulated; an
  all-f64 factor without refinement is not measured on the H100.)
* **One-hot matmuls instead of 2-D gathers.**  Frontal assembly and
  extend-add are expressed as compare-generated one-hot operands
  (`gather -> matmul` conversion), chosen where 2-D gathers were slow;
  on the H100 a (1600,112,112) extend-add gather measures 0.168 ms, at
  the launch floor (ROADMAP Queue 3 item 2).
* **Few device buffers, few programs.**  Fronts are grouped by (tree
  level, padded size class); each group executes as ONE batched dense
  program, and all index payloads are concatenated into a handful of
  flat int32 buffers (static offsets), so a plan crosses the jit
  boundary as a few device arguments, not hundreds.

The apply path is matmul-only (the factor stores inverted triangular
factors), with the right-hand side flowing THROUGH the tree: bottom-up
batched ``u = b_B − Xᵀ b_S`` sweeps, then top-down ``λ_S = L⁻ᵀL⁻¹ b_S −
X λ_B`` back-substitution into a statically-laid-out λ stream read back
with one final gather.

Planner refusal (``None``) falls back to the rounds-based path, which
remains the engine for small cores.
"""

from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "MFPlan",
    "build_nd_tree",
    "plan_multifrontal",
    "chol_inverse_batched",
    "_mf_factor",
    "_mf_apply",
]

_HI = jax.lax.Precision.HIGHEST  # f32-true matmuls (bf16 passes otherwise)


# ---------------------------------------------------------------------------
# host: graph utilities
# ---------------------------------------------------------------------------


def _csr_adjacency(core_pairs: np.ndarray, n_core: int):
    ci = np.asarray(core_pairs[:, 0], dtype=np.int64)
    cj = np.asarray(core_pairs[:, 1], dtype=np.int64)
    src = np.concatenate([ci, cj])
    dst = np.concatenate([cj, ci])
    o = np.argsort(src, kind="stable")
    src, dst = src[o], dst[o]
    indptr = np.zeros(n_core + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr), dst


def _neighbors_many(indptr: np.ndarray, dst: np.ndarray, vs: np.ndarray):
    """All neighbours of ``vs`` (with multiplicity), vectorized."""
    starts = indptr[vs]
    counts = indptr[vs + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.cumsum(counts) - counts
    pos = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
    return dst[np.repeat(starts, counts) + pos]


def _bfs_component(indptr, dst, seed: int, in_part, stamp: int, level):
    """One vectorized BFS inside the stamped part; fills ``level`` and
    returns (component nodes in BFS order, last frontier)."""
    level[seed] = 0
    frontier = np.asarray([seed], dtype=np.int64)
    order = [frontier]
    lv = 0
    while True:
        nbr = _neighbors_many(indptr, dst, frontier)
        nbr = nbr[(in_part[nbr] == stamp) & (level[nbr] < 0)]
        if nbr.size == 0:
            return np.concatenate(order), frontier
        nbr = np.unique(nbr)
        lv += 1
        level[nbr] = lv
        order.append(nbr)
        frontier = nbr


def build_nd_tree(
    core_pairs: np.ndarray, n_core: int, leaf: int = 64
) -> tuple[list[np.ndarray], list[list[int]]]:
    """Nested-dissection separator tree, postorder.

    Returns ``(pivots, children)``: ``pivots[f]`` are tree node f's pivot
    node ids (elimination-ordered within the node), ``children[f]`` the
    ids of the tree nodes it consumes.  The list is in postorder —
    children strictly precede parents — and the concatenation of
    ``pivots`` in list order is a valid elimination order (each node's
    subtree occupies a contiguous rank range ending at its own pivots).

    Same bisection rule as :func:`.core_elim.nested_dissection_order`
    (two-pass pseudo-peripheral BFS; separator = thinnest level in the
    35–65% cumulative band) with the recursion structure kept.
    """
    indptr, dst = _csr_adjacency(core_pairs, n_core)
    pivots: list[np.ndarray] = []
    children: list[list[int]] = []
    in_part = np.full(n_core, -1, dtype=np.int64)
    level = np.full(n_core, -1, dtype=np.int64)
    stamp_box = [0]

    def process(nodes: np.ndarray) -> list[int]:
        """Dissect ``nodes``; returns the top tree-node id per component."""
        tops: list[int] = []
        stamp_box[0] += 1
        stamp = stamp_box[0]
        in_part[nodes] = stamp
        level[nodes] = -1
        remaining = nodes
        comps = []
        while remaining.size:
            seed = int(remaining[0])
            comp, far = _bfs_component(indptr, dst, seed, in_part, stamp, level)
            if comp.size > leaf:
                # second pass from a pseudo-peripheral node for the levels
                level[comp] = -1
                comp, _ = _bfs_component(
                    indptr, dst, int(far[0]), in_part, stamp, level
                )
            comps.append((comp, level[comp].copy()))
            if comp.size == remaining.size:
                break
            mask = np.ones(remaining.size, dtype=bool)
            mask[np.isin(remaining, comp)] = False
            remaining = remaining[mask]
        for comp, lvs in comps:
            if comp.size <= leaf:
                pivots.append(comp)  # BFS order
                children.append([])
                tops.append(len(pivots) - 1)
                continue
            counts = np.bincount(lvs)
            cum = np.cumsum(counts)
            lo_b = int(np.searchsorted(cum, int(0.35 * comp.size)))
            hi_b = int(np.searchsorted(cum, int(0.65 * comp.size)))
            lo_b = min(max(lo_b, 1), counts.size - 1)
            hi_b = min(max(hi_b, lo_b), counts.size - 1)
            band = counts[lo_b : hi_b + 1]
            half = lo_b + int(np.argmin(band))
            sep = comp[lvs == half]
            lo = comp[lvs < half]
            hi = comp[lvs > half]
            kids: list[int] = []
            if lo.size:
                kids += process(lo)
            if hi.size:
                kids += process(hi)
            pivots.append(sep)
            children.append(kids)
            tops.append(len(pivots) - 1)
        return tops

    process(np.arange(n_core, dtype=np.int64))
    assert sum(p.size for p in pivots) == n_core
    return pivots, children


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------


class _GroupMeta(typing.NamedTuple):
    """Static (aux-data) descriptor of one batched front group."""

    k: int  # fronts in the group
    w: int  # padded pivot width
    b: int  # padded boundary width
    c: int  # padded per-pivot-row original-entry count
    nodes_off: int  # offset into nodes_all, length k*w
    cval_off: int  # offset into cval_all, length k*w*c
    ccol_off: int  # offset into ccol_all, length k*w*c
    bndpos_off: int  # offset into bndpos_all, length k*b
    lam_off: int  # this group's segment offset in the λ stream
    # consume descriptors: (child_group, cidx_off (k,), lminv_off (k*(w+b),))
    consume: tuple


class MFPlan(typing.NamedTuple):
    """Host-planned tree-multifrontal elimination (see module docs).

    All per-group index payloads live concatenated in a handful of flat
    int32 buffers; ``groups`` carries the static offsets/shapes.  The
    plan crosses jit boundaries as a runtime argument (pytree children =
    the flat buffers) so its indices are shared device buffers, not HLO
    constants.
    """

    n_core: int  # aux
    n_pairs: int  # aux: P0 (cval entries index (P0+1,))
    lam_len: int  # aux: λ stream length (sum of k*w over groups)
    n_refine: int  # aux: f64 iterative-refinement sweeps in the apply
    groups: tuple  # aux: tuple[_GroupMeta], factor/forward order
    init_slot: np.ndarray  # (P0,) global pair id per core pair
    nodes_all: np.ndarray  # int32 concat of (k, w) pivot ids, pad = n_core
    cval_all: np.ndarray  # int32 concat of (k, w, c) value idx, pad = P0
    ccol_all: np.ndarray  # int32 concat of (k, w, c) local cols, pad = m
    bndpos_all: np.ndarray  # int32 concat of (k, b) λ-stream pos, pad = lam_len
    cidx_all: np.ndarray  # int32 concat of (k,) child row indices
    lminv_all: np.ndarray  # int32 concat of (k, m) parent→child-U maps
    lam_pos: np.ndarray  # (n_core,) node -> λ stream position
    # f64 core operator for iterative refinement: y = dc⊙x − Σ_p w_p x_other
    pci: np.ndarray  # (P0,) pair endpoints, core-rank
    pcj: np.ndarray  # (P0,)
    mv_fold_i: tuple  # fold plan: per-pair contribs -> per-ci sums
    mv_fold_j: tuple  # fold plan: per-pair contribs -> per-cj sums
    mv_inv_i: np.ndarray  # (n_core,) inverse map of fold_i targets
    mv_inv_j: np.ndarray  # (n_core,)

    @property
    def stats(self) -> dict:
        ks = [g.k for g in self.groups]
        return {
            "core": self.n_core,
            "mf_groups": len(self.groups),
            "mf_fronts": int(sum(ks)),
            "front_max": max((g.w + g.b for g in self.groups), default=0),
            "index_mb": round(self.index_bytes / 1e6, 1),
        }

    @property
    def index_bytes(self) -> int:
        return sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(self)
        )


def _mfplan_flatten(p: "MFPlan"):
    children = (
        p.init_slot, p.nodes_all, p.cval_all, p.ccol_all, p.bndpos_all,
        p.cidx_all, p.lminv_all, p.lam_pos, p.pci, p.pcj,
        p.mv_fold_i, p.mv_fold_j, p.mv_inv_i, p.mv_inv_j,
    )
    aux = (p.n_core, p.n_pairs, p.lam_len, p.n_refine, p.groups)
    return children, aux


def _mfplan_unflatten(aux, children) -> "MFPlan":
    return MFPlan(*aux, *children)


jax.tree_util.register_pytree_node(MFPlan, _mfplan_flatten, _mfplan_unflatten)


def _size_class(x: int, grid_step: float = 1.5) -> int:
    """Smallest member ≥ x of a geometric size grid (multiples of 8),
    bounding padding waste at ~grid_step while keeping group count low."""
    c = 8
    while c < x:
        c = int(np.ceil(c * grid_step / 8.0)) * 8
    return c


def plan_multifrontal(
    core_pairs: np.ndarray,
    n_core: int,
    leaf: int = 64,
    front_cap: int = 16384,
    max_groups: int = 160,
    max_index_mb: float = 512.0,
    n_refine: int = 3,
) -> MFPlan | None:
    """Symbolic tree-multifrontal phase (see module docs).

    ``core_pairs`` is ``(P0, 3)`` rows ``(ci, cj, pair_id)`` in core-rank
    numbering (the ``_TreePlan.core_pairs`` layout, as for
    :func:`.core_elim.plan_core_elimination`); refusal returns ``None``
    (callers keep the rounds-based / dense fallbacks).  Budgets:
    ``front_cap`` bounds any front's padded size; ``max_groups`` bounds
    the number of batched programs (compile size); ``max_index_mb``
    bounds the index payload.  ``n_refine`` sets the f64 refinement
    sweeps the apply runs on top of the f32 factor (3 recovers ~1e-12
    relative accuracy for well-scaled cores).
    """
    P0 = int(core_pairs.shape[0])
    if n_core == 0 or P0 == 0:
        return None
    pivots, kids = build_nd_tree(core_pairs, n_core, leaf=leaf)
    nf = len(pivots)

    # postorder ranks / front membership
    rank = np.empty(n_core, dtype=np.int64)
    front_of = np.empty(n_core, dtype=np.int64)
    pos_in = np.empty(n_core, dtype=np.int64)
    r = 0
    for f in range(nf):
        piv = pivots[f]
        rank[piv] = np.arange(r, r + piv.size)
        front_of[piv] = f
        pos_in[piv] = np.arange(piv.size)
        r += piv.size

    # tree levels (children precede parents in postorder)
    tlevel = np.zeros(nf, dtype=np.int64)
    for f in range(nf):
        for ch in kids[f]:
            tlevel[f] = max(tlevel[f], tlevel[ch] + 1)

    # boundaries, bottom-up: ancestors adjacent to the subtree
    indptr, dst = _csr_adjacency(core_pairs, n_core)
    bnds: list[np.ndarray] = [np.empty(0, np.int64)] * nf
    for f in range(nf):
        piv = pivots[f]
        cand = [_neighbors_many(indptr, dst, piv)]
        cand += [bnds[ch] for ch in kids[f]]
        cand_u = np.unique(np.concatenate(cand))
        rmax = int(rank[piv].max())
        bnds[f] = cand_u[rank[cand_u] > rmax]
        if piv.size + bnds[f].size > front_cap:
            return None

    # pair → front assignment (front pivoting the lower-ranked endpoint)
    ci = np.asarray(core_pairs[:, 0], dtype=np.int64)
    cj = np.asarray(core_pairs[:, 1], dtype=np.int64)
    swap = rank[ci] > rank[cj]
    plo = np.where(swap, cj, ci)
    pup = np.where(swap, ci, cj)
    pf = front_of[plo]
    pair_order = np.argsort(pf, kind="stable")
    pair_bounds = np.searchsorted(pf[pair_order], np.arange(nf + 1))

    # per-front compact entry lists: (pivot row, local col, value idx).
    # Entries live in the pivot-row strip; S-S pairs appear on BOTH pivot
    # rows so the assembled strip is symmetric over the pivot block.
    ent_rows: list[np.ndarray] = [None] * nf  # type: ignore[list-item]
    ent_cols: list[np.ndarray] = [None] * nf  # type: ignore[list-item]
    ent_vals: list[np.ndarray] = [None] * nf  # type: ignore[list-item]
    c_real = np.zeros(nf, dtype=np.int64)
    for f in range(nf):
        sel = pair_order[pair_bounds[f] : pair_bounds[f + 1]]
        bnd = bnds[f]
        if sel.size:
            li = pos_in[plo[sel]]
            up = pup[sel]
            in_piv = front_of[up] == f
            # columns are in FRONT-LOCAL UNPADDED numbering here; shifted
            # into the padded layout (boundary cols += wpad − w_real)
            # when the group payloads are built
            lu_piv = pos_in[up]
            lu_bnd = np.searchsorted(bnd, up)
            rows = np.concatenate([li, lu_piv[in_piv]])
            cols = np.concatenate(
                [
                    np.where(in_piv, lu_piv, pivots[f].size + lu_bnd),
                    li[in_piv],
                ]
            )
            vals = np.concatenate([sel, sel[in_piv]])
        else:
            rows = cols = vals = np.empty(0, np.int64)
        ent_rows[f], ent_cols[f], ent_vals[f] = rows, cols, vals
        if rows.size:
            c_real[f] = int(np.bincount(rows).max())

    # group fronts by (tree level, pivot class, boundary class)
    w_real = np.asarray([p.size for p in pivots])
    b_real = np.asarray([b.size for b in bnds])
    keys = [
        (int(tlevel[f]), _size_class(int(w_real[f])),
         _size_class(int(b_real[f])) if b_real[f] else 0)
        for f in range(nf)
    ]
    group_ids: dict[tuple, int] = {}
    members: list[list[int]] = []
    for f in range(nf):
        g = group_ids.setdefault(keys[f], len(group_ids))
        if g == len(members):
            members.append([])
        members[g].append(f)
    if len(members) > max_groups:
        return None
    order = sorted(range(len(members)), key=lambda g: keys[members[g][0]][0])
    group_of = np.empty(nf, dtype=np.int64)
    row_of = np.empty(nf, dtype=np.int64)
    for gi, g in enumerate(order):
        for row, f in enumerate(members[g]):
            group_of[f] = gi
            row_of[f] = row

    # λ stream layout (offsets static and disjoint; back-substitution
    # writes each group's segment wherever lam_off says)
    lam_off_g = []
    lam_len = 0
    for g in order:
        lam_off_g.append(lam_len)
        f0 = members[g][0]
        lam_len += len(members[g]) * keys[f0][1]

    lam_pos = np.empty(n_core, dtype=np.int64)
    for f in range(nf):
        gi = int(group_of[f])
        wpad = keys[members[order[gi]][0]][1]
        seg = lam_off_g[gi] + row_of[f] * wpad
        lam_pos[pivots[f]] = seg + pos_in[pivots[f]]

    # per-group payloads
    nodes_parts: list[np.ndarray] = []
    cval_parts: list[np.ndarray] = []
    ccol_parts: list[np.ndarray] = []
    bndpos_parts: list[np.ndarray] = []
    cidx_parts: list[np.ndarray] = []
    lminv_parts: list[np.ndarray] = []
    groups: list[_GroupMeta] = []
    nodes_off = cv_off = bndpos_off = cidx_off = lminv_off = 0
    for gi, g in enumerate(order):
        fs = members[g]
        k = len(fs)
        _, wpad, bpad = keys[fs[0]]
        m = wpad + bpad
        cpad = max(1, int(max(c_real[fs])))
        nodes = np.full((k, wpad), n_core, dtype=np.int64)
        cval = np.full((k, wpad, cpad), P0, dtype=np.int64)
        ccol = np.full((k, wpad, cpad), m, dtype=np.int64)
        bndpos = np.full((k, bpad), lam_len, dtype=np.int64)
        con_groups: dict[tuple, list[tuple[int, int]]] = {}
        for row, f in enumerate(fs):
            piv = pivots[f]
            w_f = piv.size
            nodes[row, :w_f] = piv
            bnd = bnds[f]
            bndpos[row, : bnd.size] = lam_pos[bnd]
            rows_f, cols_f, vals_f = ent_rows[f], ent_cols[f], ent_vals[f]
            if rows_f.size:
                # boundary cols shift into the padded layout
                cols_p = np.where(
                    cols_f >= w_f, cols_f - w_f + wpad, cols_f
                )
                o = np.argsort(rows_f, kind="stable")
                rs, cs, vs = rows_f[o], cols_p[o], vals_f[o]
                slot = np.arange(rs.size) - np.searchsorted(rs, rs)
                cval[row, rs, slot] = vs
                ccol[row, rs, slot] = cs
            occ: dict[int, int] = {}
            for ch in kids[f]:
                if bnds[ch].size == 0:
                    continue  # nothing to extend-add
                cg = int(group_of[ch])
                oo = occ.get(cg, 0)
                occ[cg] = oo + 1
                con_groups.setdefault((cg, oo), []).append((row, ch))
        consume = []
        for (cg, _o), entries in sorted(con_groups.items()):
            kc = len(members[order[cg]])
            cbpad = keys[members[order[cg]][0]][2]
            cidx = np.full(k, kc, dtype=np.int64)
            lminv = np.full((k, m), cbpad, dtype=np.int64)
            for row, ch in entries:
                cidx[row] = row_of[ch]
                cb_nodes = bnds[ch]
                f = fs[row]
                in_piv = front_of[cb_nodes] == f
                ploc = np.where(
                    in_piv,
                    pos_in[cb_nodes],
                    wpad + np.searchsorted(bnds[f], cb_nodes),
                )
                lminv[row, ploc] = np.arange(cb_nodes.size)
            consume.append((cg, cidx_off, lminv_off))
            cidx_parts.append(cidx)
            lminv_parts.append(lminv.reshape(-1))
            cidx_off += k
            lminv_off += k * m
        groups.append(
            _GroupMeta(
                k=k, w=wpad, b=bpad, c=cpad,
                nodes_off=nodes_off, cval_off=cv_off, ccol_off=cv_off,
                bndpos_off=bndpos_off, lam_off=lam_off_g[gi],
                consume=tuple(consume),
            )
        )
        nodes_parts.append(nodes.reshape(-1))
        cval_parts.append(cval.reshape(-1))
        ccol_parts.append(ccol.reshape(-1))
        bndpos_parts.append(bndpos.reshape(-1))
        nodes_off += k * wpad
        cv_off += k * wpad * cpad
        bndpos_off += k * bpad

    # iterative-refinement matvec plans (exact f64 core operator)
    from .core_elim import _inverse_map, _plan_fold

    tgt_i, seg_i = np.unique(ci, return_inverse=True)
    tgt_j, seg_j = np.unique(cj, return_inverse=True)
    mv_fold_i = _plan_fold(seg_i, tgt_i.size, np.arange(P0), P0)
    mv_fold_j = _plan_fold(seg_j, tgt_j.size, np.arange(P0), P0)
    mv_inv_i = _inverse_map(tgt_i, n_core, tgt_i.size)
    mv_inv_j = _inverse_map(tgt_j, n_core, tgt_j.size)

    def cat(parts, dtype=np.int32):
        if not parts:
            return np.empty(0, dtype)
        out = np.concatenate(parts)
        assert out.size == 0 or int(out.max()) < np.iinfo(np.int32).max
        return out.astype(np.int32)

    plan = MFPlan(
        n_core=n_core,
        n_pairs=P0,
        lam_len=lam_len,
        n_refine=n_refine,
        groups=tuple(groups),
        init_slot=np.asarray(core_pairs[:, 2], dtype=np.int32),
        nodes_all=cat(nodes_parts),
        cval_all=cat(cval_parts),
        ccol_all=cat(ccol_parts),
        bndpos_all=cat(bndpos_parts),
        cidx_all=cat(cidx_parts),
        lminv_all=cat(lminv_parts),
        lam_pos=lam_pos.astype(np.int32),
        pci=ci.astype(np.int32),
        pcj=cj.astype(np.int32),
        mv_fold_i=tuple(lv.astype(np.int32) for lv in mv_fold_i),
        mv_fold_j=tuple(lv.astype(np.int32) for lv in mv_fold_j),
        mv_inv_i=mv_inv_i.astype(np.int32),
        mv_inv_j=mv_inv_j.astype(np.int32),
    )
    if plan.index_bytes > max_index_mb * 1e6:
        return None
    return plan


# ---------------------------------------------------------------------------
# device: batched dense kernel
# ---------------------------------------------------------------------------


def chol_inverse_batched(A: jnp.ndarray) -> jnp.ndarray:
    """``Li = inv(chol(A))`` (lower triangular) for a ``(k, w, w)`` batch of
    SPD blocks: stock batched Cholesky, then a batched triangular solve
    against the identity.  A non-SPD block comes back non-finite (the
    caller's pivot check)."""
    L = jnp.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    return jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)


# ---------------------------------------------------------------------------
# device: numeric phases
# ---------------------------------------------------------------------------


def _slice2(buf, off: int, k: int, n: int):
    return jax.lax.dynamic_slice(buf, (off,), (k * n,)).reshape(k, n)


def _slice3(buf, off: int, k: int, n: int, m: int):
    return jax.lax.dynamic_slice(buf, (off,), (k * n * m,)).reshape(k, n, m)


def _consume_onehot(plan, g, cg_meta, cidx_off, lminv_off, dt):
    """One-hot selection operand for a consume edge: ``P (k, u1, m)`` with
    ``P[p, a, i] = [lminv[p, i] == a]``; extend-add and rhs folds become
    matmul contractions against it (gather → matmul conversion)."""
    k, m = g.k, g.w + g.b
    u1 = cg_meta.b + 1
    lminv = _slice2(plan.lminv_all, lminv_off, k, m)
    return (lminv[:, None, :] == jnp.arange(u1)[None, :, None]).astype(dt)


def _mf_factor(plan: MFPlan, dc: jnp.ndarray, w_pairs: jnp.ndarray) -> dict:
    """Conductance-side half: batched front assembly + Cholesky sweep.

    Returns the reusable factorization (MUMPS-factor analog) consumed by
    :func:`_mf_apply` per right-hand side: per group, the inverted
    triangular factor ``Li`` and the pivot→boundary coupling ``X`` (f32
    matmul operands), plus the exact f64 diagonal/conductances for the
    refinement operator.
    """
    dt = jnp.float32
    in_dt = dc.dtype
    vals64 = -w_pairs[jnp.asarray(plan.init_slot)].astype(in_dt)
    vals_ext = jnp.concatenate([vals64.astype(dt), jnp.zeros(1, dt)])
    dc_ext = jnp.concatenate([dc.astype(dt), jnp.ones(1, dt)])
    upools: list = []
    states: list = []
    ok = jnp.asarray(True)
    for g in plan.groups:
        k, w, b, c = g.k, g.w, g.b, g.c
        m = w + b
        nodes = _slice2(plan.nodes_all, g.nodes_off, k, w)
        cval = vals_ext[_slice3(plan.cval_all, g.cval_off, k, w, c)]
        ccol = _slice3(plan.ccol_all, g.ccol_off, k, w, c)
        # pivot-row strip via one-hot expansion (pad col = m matches none)
        iota_m = jnp.arange(m)
        S = jnp.zeros((k, w, m), dt)
        for cc in range(c):
            S = S + cval[:, :, cc, None] * (
                ccol[:, :, cc, None] == iota_m
            ).astype(dt)
        low = jnp.concatenate(
            [jnp.swapaxes(S[:, :, w:], 1, 2), jnp.zeros((k, b, b), dt)],
            axis=2,
        )
        F = jnp.concatenate([S, low], axis=1)  # (k, m, m)
        dvec = jnp.concatenate([dc_ext[nodes], jnp.zeros((k, b), dt)], axis=1)
        F = F + dvec[:, :, None] * jnp.eye(m, dtype=dt)
        for cg, cidx_off, lminv_off in g.consume:
            cidx = jax.lax.dynamic_slice(plan.cidx_all, (cidx_off,), (g.k,))
            P = _consume_onehot(plan, g, plan.groups[cg], cidx_off, lminv_off, dt)
            Us = upools[cg][cidx]  # (k, u1, u1) whole-matrix slice gather
            F = F + jnp.einsum(
                "kai,kab,kbj->kij", P, Us, P, precision=_HI
            )
        Li = chol_inverse_batched(F[:, :w, :w])
        piv_ok = jnp.all(jnp.isfinite(Li))
        ok = ok & piv_ok
        if b:
            Y = jnp.einsum("kij,kjl->kil", Li, F[:, :w, w:], precision=_HI)
            X = jnp.einsum("kji,kjl->kil", Li, Y, precision=_HI)
            U = F[:, w:, w:] - jnp.einsum("kji,kjl->kil", Y, Y, precision=_HI)
            upool = jnp.pad(U, ((0, 1), (0, 1), (0, 1)))
        else:
            X = jnp.zeros((k, w, 0), dt)
            upool = jnp.zeros((k + 1, 1, 1), dt)
        upools.append(upool)
        states.append((Li, X))
    return {
        "mf": tuple(states),
        "mf_ok": ok,
        "mf_dc": dc,
        "mf_vals": vals64,
    }


def _mf_sweep(plan: MFPlan, state: dict, rc32: jnp.ndarray) -> jnp.ndarray:
    """One f32 multifrontal solve: forward through the tree, then
    back-substitution into the λ stream.  Matmul-only."""
    dt = rc32.dtype
    rc_ext = jnp.concatenate([rc32, jnp.zeros(1, dt)])
    vpools: list = []
    bS_saved: list = []
    for g, (Li, X) in zip(plan.groups, state["mf"]):
        k, w, b = g.k, g.w, g.b
        nodes = _slice2(plan.nodes_all, g.nodes_off, k, w)
        bv = jnp.concatenate([rc_ext[nodes], jnp.zeros((k, b), dt)], axis=1)
        for cg, cidx_off, lminv_off in g.consume:
            cidx = jax.lax.dynamic_slice(plan.cidx_all, (cidx_off,), (g.k,))
            P = _consume_onehot(plan, g, plan.groups[cg], cidx_off, lminv_off, dt)
            vs = vpools[cg][cidx]  # (k, u1)
            bv = bv + jnp.einsum("kai,ka->ki", P, vs, precision=_HI)
        bS = bv[:, :w]
        bS_saved.append(bS)
        if b:
            u = bv[:, w:] - jnp.einsum("kwb,kw->kb", X, bS, precision=_HI)
            vpools.append(jnp.pad(u, ((0, 1), (0, 1))))
        else:
            vpools.append(jnp.zeros((k + 1, 1), dt))

    lam_stream = jnp.zeros(plan.lam_len + 1, dt)  # trailing pad cell
    for g, (Li, X), bS in zip(
        reversed(plan.groups), reversed(state["mf"]), reversed(bS_saved)
    ):
        k, w, b = g.k, g.w, g.b
        z = jnp.einsum("kwv,kv->kw", Li, bS, precision=_HI)
        z = jnp.einsum("kvw,kv->kw", Li, z, precision=_HI)
        if b:
            bndpos = _slice2(plan.bndpos_all, g.bndpos_off, k, b)
            lamB = lam_stream[bndpos]  # ancestors only: already written
            z = z - jnp.einsum("kwb,kb->kw", X, lamB, precision=_HI)
        lam_stream = jax.lax.dynamic_update_slice(
            lam_stream, z.reshape(-1), (g.lam_off,)
        )
    return lam_stream[jnp.asarray(plan.lam_pos)]


def _mf_apply(plan: MFPlan, state: dict, rc: jnp.ndarray) -> jnp.ndarray:
    """Per-rhs half: f32 multifrontal sweeps + f64 iterative refinement.

    The f32 factor is a ~1e-6-quality inverse; ``n_refine`` refinement
    sweeps against the exact f64 core operator (host-planned fold
    reductions, no scatters) recover ~1e-12 relative accuracy."""
    from .core_elim import _fold_apply

    in_dt = rc.dtype
    dc, vals = state["mf_dc"], state["mf_vals"]
    pci = jnp.asarray(plan.pci)
    pcj = jnp.asarray(plan.pcj)

    def matvec(x):
        contrib_i = vals * x[pcj]  # pairs touch row ci with -w·x[cj]
        contrib_j = vals * x[pci]
        si = _fold_apply(contrib_i, plan.mv_fold_i)
        sj = _fold_apply(contrib_j, plan.mv_fold_j)
        si_ext = jnp.concatenate([si, jnp.zeros(1, in_dt)])
        sj_ext = jnp.concatenate([sj, jnp.zeros(1, in_dt)])
        return (
            dc * x
            + si_ext[jnp.asarray(plan.mv_inv_i)]
            + sj_ext[jnp.asarray(plan.mv_inv_j)]
        )

    x = _mf_sweep(plan, state, rc.astype(jnp.float32)).astype(in_dt)
    for _ in range(plan.n_refine):
        r = rc - matvec(x)
        x = x + _mf_sweep(plan, state, r.astype(jnp.float32)).astype(in_dt)
    return jnp.where(state["mf_ok"], x, jnp.nan)
