"""Sparse elimination of unstructured cyclic bifurcation cores.

The peel-then-core plan (:func:`networks_fenicsx_tpu.solver._plan_tree_elimination`)
eliminates tree parts fill-in-free; whatever cycle core remains was
previously factored **densely** (O(core³)) — fine for the small cores of
looped vessel networks, hopeless for large unstructured meshes.  This
module supplies the missing generality of the reference's sparse direct
solver (MUMPS, reference ``solver.py:62``): an exact sparse Cholesky-style
elimination of the SPD core Schur system with host-planned structure and a
device-executed numeric phase.

Design:

* **Host symbolic phase** (:func:`plan_core_elimination`): greedy
  minimum-degree *independent-set* ordering.  Each round eliminates a
  maximal independent set of currently-low-degree nodes; the fill edges a
  node's elimination creates among its neighbours get statically allocated
  value slots.  Rounds shrink the graph geometrically (a pure cycle halves
  every round), so the device program has O(log core) stages, not O(core).
* **Device numeric phase** (:func:`core_eliminate`): per round, one gather
  of neighbour off-diagonal values, batched rank-1 Schur updates, and
  host-pre-aggregated segment scatter-adds (sorted/unique target hints,
  the same idiom as the tree peel).  Everything is f64-exact — the
  elimination *is* an unpivoted Cholesky of an SPD matrix, so no pivoting
  or refinement is needed.
* **Dense tail**: once few nodes remain (or every remaining degree exceeds
  the padding cap) the residual system is solved with the shared scaled
  dense Cholesky kernel (:mod:`.scaled_cholesky`).
* **Supernodal front tail** (``supernodal_tail=True``): when the stalled
  remainder exceeds the single-dense-solve envelope (wide separators of
  big lattices / webs), it is eliminated multifrontally instead —
  consecutive chunks of the elimination order become dense *fronts*, each
  factored with an f64 Cholesky, its Schur complement passed
  to the first later front that pivots one of its nodes (extend-add via
  host-precomputed local index maps; a front's boundary is a clique, so
  that front provably absorbs the whole update matrix).  This is the
  multifrontal method of sparse direct solvers (MUMPS' own structure),
  with fronts as batched dense ops.

The planner returns ``None`` when fill blows past its budget (strongly
non-planar cores); callers then keep the previous dense/CG behaviour.
"""

from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp

from .scaled_cholesky import scaled_cholesky_factor, scaled_cholesky_solve

_HI = jax.lax.Precision.HIGHEST  # no TF32 passes in the float32 mode

__all__ = [
    "CoreElimPlan",
    "nested_dissection_order",
    "plan_core_elimination",
    "core_eliminate",
    "_core_factor",
    "_core_apply",
]


def nested_dissection_order(
    core_pairs: np.ndarray, n_core: int, leaf: int = 64
) -> np.ndarray:
    """Level-structure nested-dissection elimination order.

    Recursive graph bisection: BFS levels from a pseudo-peripheral node
    split each component at the median level; that level's nodes form the
    separator, appended AFTER both halves.  Leaf components (< ``leaf``
    nodes) keep BFS order.  Where greedy minimum-degree fill blows up —
    large 2-D lattice cores are the canonical case (MUMPS uses METIS ND
    there) — this order bounds fill near the O(n log n) ND asymptotic,
    letting :func:`plan_core_elimination` stay within its budget.
    """
    # CSR adjacency
    ci = np.asarray(core_pairs[:, 0], dtype=np.int64)
    cj = np.asarray(core_pairs[:, 1], dtype=np.int64)
    src = np.concatenate([ci, cj])
    dst = np.concatenate([cj, ci])
    o = np.argsort(src, kind="stable")
    src, dst = src[o], dst[o]
    indptr = np.zeros(n_core + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)

    def neighbors(v: int) -> np.ndarray:
        return dst[indptr[v] : indptr[v + 1]]

    order: list[np.ndarray] = []
    # worklist of (nodes, emit_after): separators are pushed to emit after
    # both halves complete (LIFO preserves the recursive emission order)
    in_part = np.full(n_core, -1, dtype=np.int64)  # partition stamp
    stamp = 0
    stack: list[tuple[np.ndarray, bool]] = [
        (np.arange(n_core, dtype=np.int64), False)
    ]
    while stack:
        nodes, is_sep = stack.pop()
        if is_sep or nodes.size <= leaf:
            order.append(nodes)
            continue
        stamp += 1
        in_part[nodes] = stamp
        # BFS levels from a pseudo-peripheral node of this part (first
        # BFS finds a far node; second BFS from it gives the levels).
        # Parts can be disconnected (separator removal); handle per seed.
        level = np.full(n_core, -1, dtype=np.int64)
        remaining = nodes
        comp_sets = []
        while remaining.size:
            seed = int(remaining[0])
            for _pass in range(2):
                level[nodes] = -1
                level[seed] = 0
                frontier = [seed]
                comp = [seed]
                far = seed
                lv = 0
                while frontier:
                    lv += 1
                    nxt = []
                    for v in frontier:
                        for w in neighbors(v):
                            w = int(w)
                            if in_part[w] == stamp and level[w] < 0:
                                level[w] = lv
                                nxt.append(w)
                                comp.append(w)
                    if nxt:
                        far = nxt[0]
                    frontier = nxt
                seed = far  # second pass starts from the far end
            comp_arr = np.asarray(comp, dtype=np.int64)
            # capture levels NOW — the next component's BFS resets them
            comp_sets.append((comp_arr, level[comp_arr].copy()))
            mask = np.ones(remaining.size, dtype=bool)
            mask[np.isin(remaining, comp_arr)] = False
            remaining = remaining[mask]
        for comp_arr, lvs in comp_sets:
            if comp_arr.size <= leaf:
                order.append(comp_arr)
                continue
            # separator: the THINNEST level within the middle band of the
            # cumulative count (35-65%) — exact-median levels on irregular
            # graphs can be fat, and separator width drives both fill and
            # the dense-tail size
            counts = np.bincount(lvs)
            cum = np.cumsum(counts)
            lo_b = int(np.searchsorted(cum, int(0.35 * comp_arr.size)))
            hi_b = int(np.searchsorted(cum, int(0.65 * comp_arr.size)))
            lo_b = min(max(lo_b, 1), counts.size - 1)
            hi_b = min(max(hi_b, lo_b), counts.size - 1)
            band = counts[lo_b : hi_b + 1]
            half = lo_b + int(np.argmin(band))
            sep = comp_arr[lvs == half]
            lo = comp_arr[lvs < half]
            hi = comp_arr[lvs > half]
            stack.append((sep, True))  # emitted after both halves (LIFO)
            if hi.size:
                stack.append((hi, False))
            if lo.size:
                stack.append((lo, False))
    out = np.concatenate(order) if order else np.empty(0, np.int64)
    assert out.size == n_core
    return out


class _Round(typing.NamedTuple):
    """One elimination round, formulated WITHOUT a materialized slot-value
    array.

    Indexed access (scatter or gather) costs far more per element than a
    slice, so a per-round op touching the full (n_slots,)-sized state
    would dominate at large cores (36 such rounds at 320²).  Instead the
    elimination is LEFT-LOOKING over
    an update STREAM: each round appends its per-slot Schur sums at a
    static offset (contiguous ``dynamic_update_slice`` — free), and a
    slot's single read (every slot is read exactly once, in the round
    that eliminates one of its endpoints, or by a front / the dense
    tail) gather-folds its own updates from the stream.  All remaining
    per-round index work is proportional to the round's read/write sets.
    """

    elim: np.ndarray  # (S,) core-rank node ids, sorted ascending
    nbr_node: np.ndarray  # (S, K) neighbour core-rank ids, pad = Bc
    # slot-value reads: a = vals_init_ext[init_idx] - fold(ustream, u_read)
    init_idx: np.ndarray  # (S, K) index into (P0+1,) init values, pad = P0
    u_read: tuple  # fold plan: ustream -> (S*K,) prior-update sums
    # diagonal / rhs updates, as a gather-FOLD plan (see _plan_fold): the
    # (S*K) neighbour grid folds into one sum per touched node, applied
    # back through a full-size inverse gather (n_core-sized — cheap
    # relative to the slot axis).
    d_fold: tuple  # tuple of (n_i, w_i) int arrays; level-1 indexes (S*K)
    d_inv: np.ndarray  # (Bc,) node -> row of the folded sums, pad = U1
    # off-diagonal Schur updates: index PAIRS into the (S*K) grid produce
    # the (M2,) contribution vector; u_fold folds it per target slot into
    # this round's ustream segment (written at offset u_off).
    u_src_i: np.ndarray  # (M2,)
    u_src_j: np.ndarray  # (M2,)
    u_fold: tuple  # fold plan over the (M2,) contribution vector
    u_off: int  # static offset of this round's (U2,) segment in ustream
    e_inv: np.ndarray  # (Bc + 1,) node -> row in elim, pad = S (backsub)


class _Front(typing.NamedTuple):
    """One supernodal front: a pivot chunk S plus its boundary clique B.

    Local index space is ``[S | B]`` (m = w + b entries).  ``slot_*``
    scatter the sparse value slots whose pair has at least one endpoint in
    S into the frontal matrix; pairs fully inside B are NOT assembled here
    (they belong to the front that later pivots them).  ``consume`` lists
    earlier fronts whose update matrices extend-add into this one, with a
    local index map for each (their boundary is a clique, so the first
    front pivoting any member contains all of them — see module docs).
    """

    nodes: np.ndarray  # (w,) core-rank pivot ids, elimination-ordered
    bnd: np.ndarray  # (b,) core-rank boundary ids, sorted ascending
    slot_val: np.ndarray  # (ns,) value-slot ids
    slot_i: np.ndarray  # (ns,) local row index in [S | B]
    slot_j: np.ndarray  # (ns,) local col index (slot_i < slot_j)
    consume: tuple  # tuple[(front_id, (m,) INVERSE index map, pad=m_c), ...]
    # slot-value reads (see _Round): sval = init_ext[f_init] - fold(ustream)
    f_init: np.ndarray = np.empty(0, np.int64)  # (ns,) into (P0+1,), pad P0
    f_fold: tuple = ()  # fold plan: ustream -> (ns,) prior-update sums


class CoreElimPlan(typing.NamedTuple):
    """Host-planned sparse elimination of a cycle core (see module docs)."""

    n_core: int  # number of core nodes Bc
    n_slots: int  # off-diagonal value slots (original pairs + fill)
    init_slot: np.ndarray  # (P0,) global pair id feeding slot p (p < P0)
    rounds: tuple  # tuple[_Round]
    dense_nodes: np.ndarray  # (Bd,) core-rank ids solved densely at the top
    dense_pairs: np.ndarray  # (Pd, 3) (di, dj, slot) for the dense tail
    fill_slots: int  # diagnostic: slots added beyond the original pairs
    fronts: tuple = ()  # tuple[_Front] — supernodal tail (excludes dense)
    mu_all: int = 0  # total update-stream length (Σ per-round U2)
    # dense-pair slot reads (see _Round): init gather + update fold
    dp_init: np.ndarray = np.empty(0, np.int64)  # (Pd,) into (P0+1,)
    dp_fold: tuple = ()  # fold plan: ustream -> (Pd,) prior-update sums

    @property
    def stats(self) -> dict:
        return {
            "core": self.n_core,
            "rounds": len(self.rounds),
            "slots": self.n_slots,
            "fill": self.fill_slots,
            "dense_tail": int(self.dense_nodes.size),
            "fronts": len(self.fronts),
            "front_max": max(
                (f.nodes.size + f.bnd.size for f in self.fronts), default=0
            ),
        }

    @property
    def index_bytes(self) -> int:
        """Total bytes of the plan's index arrays (the would-be HLO
        literal payload if the plan is closed over instead of passed as
        a runtime argument)."""
        return sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(self)
        )


# Register the plan (and its front tuples) as pytrees: index arrays are
# CHILDREN, structural ints are static aux data.  This lets a plan cross a
# ``jit`` boundary as a runtime ARGUMENT — device buffers transferred once
# — instead of being baked into the program as literal constants.  At
# supernodal scale the constants are the program: a 320² per-edge-R
# lattice plan carries ~450 MB of int64 indices, which (a) bloats the
# serialized HLO past what compile services accept, (b) slows XLA
# ingestion, and (c) duplicates the arrays into every executable (fused,
# factor, apply) that embeds them.  ``_Round`` gets an EXPLICIT
# registration (below) rather than relying on NamedTuple structural
# flattening: ``u_off`` must stay static aux data — it feeds
# ``dynamic_update_slice`` offsets, which need trace-time constants —
# while every other field is a traced array child.
def _round_flatten(r: "_Round"):
    children = (
        r.elim, r.nbr_node, r.init_idx, r.u_read, r.d_fold, r.d_inv,
        r.u_src_i, r.u_src_j, r.u_fold, r.e_inv,
    )
    return children, (r.u_off,)


def _round_unflatten(aux, children) -> "_Round":
    (elim, nbr_node, init_idx, u_read, d_fold, d_inv,
     u_src_i, u_src_j, u_fold, e_inv) = children
    return _Round(
        elim=elim, nbr_node=nbr_node, init_idx=init_idx, u_read=u_read,
        d_fold=d_fold, d_inv=d_inv, u_src_i=u_src_i, u_src_j=u_src_j,
        u_fold=u_fold, u_off=aux[0], e_inv=e_inv,
    )


def _front_flatten(f: "_Front"):
    children = (
        f.nodes, f.bnd, f.slot_val, f.slot_i, f.slot_j,
        tuple(lmap for _, lmap in f.consume), f.f_init, f.f_fold,
    )
    aux = tuple(int(cid) for cid, _ in f.consume)
    return children, aux


def _front_unflatten(aux, children) -> "_Front":
    nodes, bnd, slot_val, slot_i, slot_j, cons_maps, f_init, f_fold = children
    return _Front(
        nodes=nodes, bnd=bnd, slot_val=slot_val, slot_i=slot_i,
        slot_j=slot_j, consume=tuple(zip(aux, cons_maps)),
        f_init=f_init, f_fold=f_fold,
    )


def _plan_flatten(p: "CoreElimPlan"):
    children = (
        p.init_slot, p.rounds, p.dense_nodes, p.dense_pairs, p.fronts,
        p.dp_init, p.dp_fold,
    )
    aux = (p.n_core, p.n_slots, p.fill_slots, p.mu_all)
    return children, aux


def _plan_unflatten(aux, children) -> "CoreElimPlan":
    (init_slot, rounds, dense_nodes, dense_pairs, fronts,
     dp_init, dp_fold) = children
    n_core, n_slots, fill_slots, mu_all = aux
    return CoreElimPlan(
        n_core=n_core, n_slots=n_slots, init_slot=init_slot, rounds=rounds,
        dense_nodes=dense_nodes, dense_pairs=dense_pairs,
        fill_slots=fill_slots, fronts=fronts, mu_all=mu_all,
        dp_init=dp_init, dp_fold=dp_fold,
    )


jax.tree_util.register_pytree_node(_Round, _round_flatten, _round_unflatten)
jax.tree_util.register_pytree_node(_Front, _front_flatten, _front_unflatten)
jax.tree_util.register_pytree_node(CoreElimPlan, _plan_flatten, _plan_unflatten)


def _plan_fold(
    seg: np.ndarray, U: int, src: np.ndarray, src_len: int, cap: int = 64
) -> tuple:
    """Host plan for an exact gather-fold segment reduction.

    Returns a tuple of padded 2-D int index arrays ("levels") such that
    :func:`_fold_apply` sums the entries of a length-``src_len`` vector
    into ``(U,)`` per-segment totals using only gathers and row sums —
    a fixed-order replacement for ``segment_sum``/scatter-add.
    ``seg[i]``/``src[i]`` give entry i's
    segment and its index into the source vector.  Pad cells index one
    past the level's input (the appended zero).  Segments wider than
    ``cap`` fold through intermediate chunk levels, so summation is an
    exact f64 tree reduction at any width.
    """
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind="stable")
    cur = np.asarray(src, dtype=np.int64)[order]
    cur_counts = np.bincount(seg, minlength=U).astype(np.int64)
    cur_len = int(src_len)
    levels: list[np.ndarray] = []
    while True:
        W = int(cur_counts.max()) if cur_counts.size else 0
        n_grp = int(cur_counts.size)
        if W <= cap:
            lv = np.full((n_grp, max(W, 1)), cur_len, dtype=np.int64)
            offs = np.concatenate([[0], np.cumsum(cur_counts)])
            col = np.arange(cur.size) - np.repeat(offs[:-1], cur_counts)
            row = np.repeat(np.arange(n_grp), cur_counts)
            lv[row, col] = cur
            levels.append(lv)
            return tuple(levels)
        offs = np.concatenate([[0], np.cumsum(cur_counts)])
        pos = np.arange(cur.size) - np.repeat(offs[:-1], cur_counts)
        n_chunks_grp = (cur_counts + cap - 1) // cap
        chunk_offs = np.concatenate([[0], np.cumsum(n_chunks_grp)])
        chunk_id = np.repeat(chunk_offs[:-1], cur_counts) + pos // cap
        n_chunks = int(chunk_offs[-1])
        lv = np.full((n_chunks, cap), cur_len, dtype=np.int64)
        lv[chunk_id, pos % cap] = cur
        levels.append(lv)
        cur = np.arange(n_chunks, dtype=np.int64)
        cur_counts = n_chunks_grp
        cur_len = n_chunks


def _fold_apply(vec: jnp.ndarray, levels: tuple) -> jnp.ndarray:
    """Apply a :func:`_plan_fold` plan: (src_len,) vector → (U,) sums."""
    for lv in levels:
        vec = jnp.concatenate([vec, jnp.zeros(1, vec.dtype)])
        vec = vec[jnp.asarray(lv)].sum(axis=1)
    return vec


def _fold_apply_pre(vec_ext: jnp.ndarray, levels: tuple) -> jnp.ndarray:
    """:func:`_fold_apply` for a vector that ALREADY carries its trailing
    zero cell (``vec_ext[src_len] == 0``).

    The update stream is read by every round, so appending the pad cell
    per read would copy the whole (mu_all,)-sized buffer each time;
    preallocating it once makes the level-0 read a pure gather.
    Intermediate levels operate on small chunk vectors and keep the
    append."""
    vec = vec_ext[jnp.asarray(levels[0])].sum(axis=1)
    for lv in levels[1:]:
        vec = jnp.concatenate([vec, jnp.zeros(1, vec.dtype)])
        vec = vec[jnp.asarray(lv)].sum(axis=1)
    return vec


def _inverse_map(targets: np.ndarray, size: int, pad_rows: int) -> np.ndarray:
    """(size,) map: position of index i in ``targets`` (else ``pad_rows``),
    for applying folded sums back through a gather instead of a scatter."""
    inv = np.full(size, pad_rows, dtype=np.int64)
    inv[np.asarray(targets, dtype=np.int64)] = np.arange(
        targets.size, dtype=np.int64
    )
    return inv


def _plan_fronts(
    adj: list, tail_order: np.ndarray, front_max: int, front_cap: int
) -> tuple | None:
    """Symbolic multifrontal elimination of the stalled tail.

    ``tail_order`` is the remaining alive nodes in elimination order;
    consecutive chunks of ``front_max`` become dense fronts.  ``adj`` is
    the post-sparse-rounds adjacency (node -> {nbr: slot}) — read only.
    Returns ``None`` when a front would exceed ``front_cap`` (host/HBM
    safety: callers keep the dense/CG fallback).
    """
    cliques: list[np.ndarray] = []  # update-matrix member lists
    node_cliques: dict[int, set] = {}
    elim: set = set()
    fronts: list[_Front] = []
    for start in range(0, tail_order.size, front_max):
        S = np.asarray(tail_order[start : start + front_max], dtype=np.int64)
        Sset = {int(v) for v in S}
        B: set = set()
        consume_ids: set = set()
        for v in Sset:
            for w in adj[v]:
                if w not in elim and w not in Sset:
                    B.add(w)
            for c in node_cliques.get(v, ()):
                consume_ids.add(c)
        for c in consume_ids:
            for w in cliques[c]:
                w = int(w)
                if w not in elim and w not in Sset:
                    B.add(w)
        bnd = np.asarray(sorted(B), dtype=np.int64)
        w_ = int(S.size)
        if w_ + bnd.size > front_cap:
            return None
        loc = {int(v): i for i, v in enumerate(S)}
        for i, v in enumerate(bnd):
            loc[int(v)] = w_ + i
        sv: list[int] = []
        si: list[int] = []
        sj: list[int] = []
        # sparse values with >= 1 endpoint in S; B-B pairs assemble later,
        # in the front that pivots them
        for v in Sset:
            lv = loc[v]
            for w, slot in adj[v].items():
                if w in elim:
                    continue
                lw = loc[w]
                if w in Sset and lw < lv:
                    continue  # S-S pairs once, from the lower-local side
                sv.append(slot)
                si.append(min(lv, lw))
                sj.append(max(lv, lw))
        consume: list[tuple[int, np.ndarray]] = []
        m_f = w_ + int(bnd.size)
        for c in sorted(consume_ids):
            # no clique member is ever eliminated before consumption (the
            # eliminating front consumes it), so every member has a slot
            # in [S | B] — a KeyError here would be a planner bug.
            # Stored as the INVERSE map (F-local -> update-local, pad =
            # m_c): the extend-add then runs as an (m, m) gather from the
            # padded update matrix instead of a serialized 2-D scatter.
            lmap = np.asarray([loc[int(w)] for w in cliques[c]], dtype=np.int64)
            lminv = np.full(m_f, lmap.size, dtype=np.int64)
            lminv[lmap] = np.arange(lmap.size, dtype=np.int64)
            consume.append((c, lminv))
            for w in cliques[c]:
                node_cliques.get(int(w), set()).discard(c)
        fid = len(fronts)
        fronts.append(
            _Front(
                nodes=S,
                bnd=bnd,
                slot_val=np.asarray(sv, dtype=np.int64),
                slot_i=np.asarray(si, dtype=np.int64),
                slot_j=np.asarray(sj, dtype=np.int64),
                consume=tuple(consume),
            )
        )
        if bnd.size:
            cid = len(cliques)
            assert cid == fid  # one clique per front, same numbering
            cliques.append(bnd)
            for w in bnd:
                node_cliques.setdefault(int(w), set()).add(cid)
        else:
            cliques.append(np.empty(0, np.int64))  # keep ids aligned
        elim.update(Sset)
    assert not any(node_cliques.values()), "unconsumed update matrices"
    return tuple(fronts)


def plan_core_elimination(
    core_pairs: np.ndarray,
    n_core: int,
    dense_cutoff: int = 384,
    kcap: int = 32,
    max_fill_ratio: float = 60.0,
    max_slots: int = 20_000_000,
    tail_stop: bool = True,
    order: np.ndarray | None = None,
    dense_cap: int | None = None,
    supernodal_tail: bool = False,
    front_max: int = 1024,
    front_cap: int = 16384,
    front_stop: bool = True,
) -> CoreElimPlan | None:
    """Symbolic minimum-degree independent-set elimination.

    Args:
        core_pairs: ``(P0, 3)`` rows ``(ci, cj, pair_id)`` in core-rank
            numbering (the ``_TreePlan.core_pairs`` layout).
        n_core: number of core nodes.
        dense_cutoff: stop eliminating and solve the remainder densely
            once this few nodes remain.
        kcap: maximum neighbour count an eliminated node may have (bounds
            the per-round padding width).
        max_fill_ratio / max_slots: fill budget — beyond it the planner
            gives up (returns ``None``) and the caller keeps the dense/CG
            fallback.
        tail_stop: apply the diminishing-returns stop (see the loop
            comment).  ``False`` forces the sparse rounds all the way to
            ``dense_cutoff`` — used by tests that pin the sparse numeric
            phase on small cores where the stop would otherwise keep the
            whole core dense.
        order: optional elimination order (e.g.
            :func:`nested_dissection_order`): per round every alive node
            that is a rank-local-minimum among its alive neighbours
            eliminates (parallel pivoting — fill equals the sequential
            order's, rounds = elimination-tree height).  Bounds fill on
            large lattice-like cores where greedy min-degree blows the
            budget; wide separator cliques (degree > kcap under any
            order) land in the dense tail, as in a multifrontal solver.
        dense_cap: maximum dense-tail size (default
            ``max(dense_cutoff, 4096)``).  ND orders on big lattices
            stall with top-separator tails of 4-8k — one dense
            factorization each, so the ND caller raises this.
        supernodal_tail: when the stalled remainder exceeds ``dense_cap``,
            eliminate it multifrontally (see :func:`_plan_fronts`)
            instead of giving up — the path for per-edge-R lattices
            beyond ~300 per side and very large webs.
        front_max: pivot-chunk width of each supernodal front.
        front_cap: hard bound on a front's total size (pivots +
            boundary); beyond it the planner returns ``None``.
        front_stop: with ``supernodal_tail``, break out of the rounds as
            soon as a round shrinks below ``max(64, n_alive/64)`` pivots
            and let the fronts absorb the remainder.  The sliver tail is
            pure launch overhead on device (on a 512² lattice the last 32
            of 68 rounds eliminate ~2k of 262k nodes), while the few extra
            front pivots are cheap dense work.  Disabled on a retry when
            the wider
            remainder makes a front outgrow ``front_cap``.

    Returns None when the core is empty or the fill budget is exceeded.
    """
    P0 = int(core_pairs.shape[0])
    if n_core == 0:
        return None
    budget = min(max_slots, int(max(P0, n_core) * max_fill_ratio) + 1024)

    # adjacency: node -> {nbr: slot}
    adj: list[dict[int, int]] = [dict() for _ in range(n_core)]
    for p, (ci, cj, _pid) in enumerate(np.asarray(core_pairs, dtype=np.int64)):
        adj[int(ci)][int(cj)] = p
        adj[int(cj)][int(ci)] = p
    n_slots = P0
    alive = np.ones(n_core, dtype=bool)
    n_alive = n_core
    rounds: list[dict] = []  # _Round fields; assembled post-loop (stream)
    rank = None
    low_cnt = None
    pool: set = set()
    if order is not None:
        order = np.asarray(order, dtype=np.int64)
        rank = np.empty(n_core, dtype=np.int64)
        rank[order] = np.arange(n_core, dtype=np.int64)
        # incremental local-min bookkeeping: low_cnt[v] = alive neighbours
        # of lower rank; v is eligible exactly when it reaches 0.  Kept in
        # sync through eliminations (decrements) and fill edges (the
        # higher-rank endpoint gains a lower-rank neighbour) — replaces a
        # full O(n_core) eligibility scan per round (68 rounds x 262k
        # nodes at 512² cost ~2 min of host time).
        low_cnt = np.zeros(n_core, dtype=np.int64)
        for v in range(n_core):
            rv_ = rank[v]
            low_cnt[v] = sum(1 for w in adj[v] if rank[w] < rv_)
        pool = {v for v in range(n_core) if low_cnt[v] == 0}

    while n_alive > dense_cutoff:
        if rank is not None:
            # parallel pivoting consistent with the given order: eliminate
            # every alive node that is a rank-local-MINIMUM among its
            # alive neighbours (non-adjacent by construction; the fill is
            # exactly the sequential-order fill, rounds = elimination-tree
            # height).  Wide separator cliques serialize under any order,
            # so nodes beyond kcap are left for the dense tail.
            chosen = []
            stale = []
            for v in pool:
                if not alive[v] or low_cnt[v] != 0:
                    stale.append(v)  # re-added on the decrement to 0
                elif len(adj[v]) <= kcap:
                    chosen.append(v)
                # else: eligible but over-wide — stays pooled; its degree
                # shrinks as neighbours eliminate
            pool.difference_update(stale)
        else:
            # candidates: independent set of minimum-ish degree nodes
            degs = {v: len(adj[v]) for v in range(n_core) if alive[v]}
            dmin = min(degs.values())
            thresh = min(kcap, max(dmin + 2, 4))
            blocked = set()
            chosen = []
            for v in sorted(degs, key=degs.get):  # type: ignore[arg-type]
                if degs[v] > thresh:
                    break
                if v in blocked:
                    continue
                chosen.append(v)
                blocked.add(v)
                blocked.update(adj[v])
        if not chosen:
            break  # every remaining node exceeds kcap: dense tail
        # Diminishing-returns stop: once independent sets shrink to
        # slivers (fill pushes every degree near the threshold) a long
        # tail of tiny device rounds costs more fixed launches than one
        # dense solve of the remainder.  At 10k junctions, without the
        # stop the last ~40 rounds eliminate 1-8 nodes each (76 rounds,
        # 16k HLO lines); stopping at a ≤2048-node remainder gives 25
        # rounds / ~4k lines.  Only when the remainder fits the dense
        # envelope.
        if tail_stop and n_alive <= 2048 and len(chosen) < max(16, n_alive // 32):
            break
        # Front-stop: with a supernodal tail available there is no reason
        # to crawl through sliver rounds at ANY size — the fronts factor
        # the remainder in a handful of dense Choleskys.
        if (
            supernodal_tail
            and front_stop
            and len(chosen) < max(64, n_alive // 64)
        ):
            break
        chosen.sort()
        K = max((len(adj[v]) for v in chosen), default=1)
        K = max(K, 1)
        S = len(chosen)
        nbr_node = np.full((S, K), n_core, dtype=np.int64)
        nbr_slot = np.full((S, K), -1, dtype=np.int64)  # -1 pads consumed by init_idx/_read_fold
        d_entries: list[tuple[int, int]] = []  # (flat_src, tgt_node)
        u_entries: list[tuple[int, int, int]] = []  # (src_i, src_j, tgt_slot)
        for s, v in enumerate(chosen):
            nbrs = sorted(adj[v].items())
            for k, (n, slot) in enumerate(nbrs):
                nbr_node[s, k] = n
                nbr_slot[s, k] = slot
                d_entries.append((s * K + k, n))
            # fill: clique among the neighbours
            for i in range(len(nbrs)):
                ni = nbrs[i][0]
                for j in range(i + 1, len(nbrs)):
                    nj = nbrs[j][0]
                    slot = adj[ni].get(nj)
                    if slot is None:
                        slot = n_slots
                        n_slots += 1
                        adj[ni][nj] = slot
                        adj[nj][ni] = slot
                        if low_cnt is not None:
                            # new edge: the higher-rank endpoint gains a
                            # lower-rank alive neighbour
                            hi = ni if rank[ni] > rank[nj] else nj
                            low_cnt[hi] += 1
                    u_entries.append((s * K + i, s * K + j, slot))
            # remove v
            for n, _slot in nbrs:
                del adj[n][v]
                if low_cnt is not None and rank[n] > rank[v]:
                    low_cnt[n] -= 1
                    if low_cnt[n] == 0:
                        pool.add(n)
            adj[v] = {}
            alive[v] = False
        n_alive -= S
        if n_slots > budget:
            return None

        d_src = np.array([e[0] for e in d_entries], dtype=np.int64)
        d_tgt_all = np.array([e[1] for e in d_entries], dtype=np.int64)
        d_tgt, d_seg = np.unique(d_tgt_all, return_inverse=True)
        d_fold = _plan_fold(d_seg, d_tgt.size, d_src, S * K)
        d_inv = _inverse_map(d_tgt, n_core, d_tgt.size)
        if u_entries:
            u_src_i = np.array([e[0] for e in u_entries], dtype=np.int64)
            u_src_j = np.array([e[1] for e in u_entries], dtype=np.int64)
            u_tgt_all = np.array([e[2] for e in u_entries], dtype=np.int64)
            u_tgt, u_seg = np.unique(u_tgt_all, return_inverse=True)
            u_fold = _plan_fold(
                u_seg, u_tgt.size, np.arange(u_src_i.size), u_src_i.size
            )
        else:
            u_src_i = u_src_j = np.empty(0, dtype=np.int64)
            u_tgt = np.empty(0, dtype=np.int64)
            u_fold = ()
        elim_arr = np.asarray(chosen, dtype=np.int64)
        e_inv = _inverse_map(elim_arr, n_core + 1, S)
        # _Round assembled post-loop (the update-stream read folds need
        # the global update records and final slot pads)
        rounds.append(
            dict(
                elim=elim_arr,
                nbr_node=nbr_node,
                nbr_slot=nbr_slot,
                d_fold=d_fold,
                d_inv=d_inv,
                u_src_i=u_src_i,
                u_src_j=u_src_j,
                u_fold=u_fold,
                u_tgt=u_tgt,
                e_inv=e_inv,
            )
        )

    dense_nodes = np.flatnonzero(alive).astype(np.int64)
    fronts: tuple = ()
    cap = dense_cap if dense_cap is not None else max(dense_cutoff, 4096)
    if dense_nodes.size > cap:
        if not supernodal_tail:
            return None  # fill forced a huge dense tail: not worth it
        tail_order = (
            dense_nodes[np.argsort(rank[dense_nodes], kind="stable")]
            if rank is not None
            else dense_nodes
        )
        planned = _plan_fronts(adj, tail_order, front_max, front_cap)
        if planned is None:
            return None  # a front outgrew the cap: keep dense/CG fallback
        fronts = planned
        dense_nodes = np.empty(0, np.int64)
    rank = np.full(n_core, -1, dtype=np.int64)
    rank[dense_nodes] = np.arange(dense_nodes.size)
    dense_pairs: list[tuple[int, int, int]] = []
    for v in dense_nodes:
        for n, slot in adj[int(v)].items():
            if v < n:
                dense_pairs.append((int(rank[v]), int(rank[n]), slot))
    dp = (
        np.asarray(dense_pairs, dtype=np.int64)
        if dense_pairs
        else np.empty((0, 3), dtype=np.int64)
    )

    # ---- update-stream assembly (see the _Round docstring) ----
    # Pass 1: static per-round stream offsets and the global write record
    # (stream position -> target slot).  Round r's unique target slots
    # u_tgt occupy stream positions [u_off_r, u_off_r + |u_tgt|).
    u_offs: list[int] = []
    mu_all = 0
    for rdd in rounds:
        u_offs.append(mu_all)
        mu_all += int(rdd["u_tgt"].size)
    w_slot = (
        np.concatenate([np.asarray(rdd["u_tgt"], dtype=np.int64) for rdd in rounds])
        if rounds
        else np.empty(0, np.int64)
    )
    o = np.argsort(w_slot, kind="stable")
    ws = w_slot[o]  # write slots, sorted
    ps = np.arange(mu_all, dtype=np.int64)[o]  # positions, ascending per slot

    def _read_fold(slots_flat: np.ndarray, cutoff: int, n_reads: int) -> tuple:
        """Fold plan summing each read's prior stream writes (< cutoff).

        ``slots_flat[i]`` is read i's slot id (< 0 = pad, no reads).
        Every stream position is read exactly once across the whole plan
        (each slot is consumed by exactly one round / front / dense pair),
        so the total fold work equals the stream length."""
        valid = np.flatnonzero(slots_flat >= 0)
        fs = slots_flat[valid]
        lo = np.searchsorted(ws, fs)
        hi = np.searchsorted(ws, fs, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return ()
        rep = np.repeat(np.arange(fs.size), counts)
        within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        srcp = ps[lo[rep] + within]
        m = srcp < cutoff
        if not m.any():
            return ()
        return _plan_fold(valid[rep[m]], n_reads, srcp[m], mu_all)

    final_rounds: list[_Round] = []
    for rdd, u_off in zip(rounds, u_offs):
        nbr_slot = rdd.pop("nbr_slot")
        rdd.pop("u_tgt")
        S, K = nbr_slot.shape
        flat = nbr_slot.reshape(-1)
        init_idx = np.where((flat >= 0) & (flat < P0), flat, P0).reshape(S, K)
        final_rounds.append(
            _Round(
                init_idx=init_idx,
                u_read=_read_fold(flat, u_off, S * K),
                u_off=u_off,
                **rdd,
            )
        )
    if fronts:
        fronts = tuple(
            fr._replace(
                f_init=np.where(fr.slot_val < P0, fr.slot_val, P0),
                f_fold=_read_fold(fr.slot_val, mu_all, int(fr.slot_val.size)),
            )
            for fr in fronts
        )
    dp_init = np.where(dp[:, 2] < P0, dp[:, 2], P0)
    dp_fold = _read_fold(dp[:, 2], mu_all, int(dp.shape[0]))

    plan = CoreElimPlan(
        n_core=n_core,
        n_slots=n_slots,
        init_slot=np.asarray(core_pairs[:, 2], dtype=np.int64),
        rounds=tuple(final_rounds),
        dense_nodes=dense_nodes,
        dense_pairs=dp,
        fill_slots=n_slots - P0,
        fronts=fronts,
        mu_all=mu_all,
        dp_init=dp_init,
        dp_fold=dp_fold,
    )
    # Index compaction: the plan rides to the device as runtime buffers
    # (see the pytree registration), so narrowing int64 indices to int32
    # where the values fit halves both the transfer and its resident HBM.
    # Per-array check: different arrays index different spaces (nodes,
    # init values, stream positions, fold chunks) with different bounds.
    i32max = np.iinfo(np.int32).max

    def _compact(a):
        if (
            isinstance(a, np.ndarray)
            and a.dtype == np.int64
            and (a.size == 0 or int(a.max()) < i32max)
        ):
            return a.astype(np.int32)
        return a

    return jax.tree_util.tree_map(_compact, plan)


def _core_factor(
    plan: CoreElimPlan, dc: jnp.ndarray, w_pairs: jnp.ndarray
) -> dict:
    """Conductance-side half: value elimination + dense-tail Cholesky.

    Depends on the core diagonal ``dc`` and per-pair conductances only —
    the reusable factorization (MUMPS-factor analog).  Returns a device
    pytree consumed by :func:`_core_apply` per right-hand side.

    Dispatches to the tree-multifrontal engine when the attached plan is
    an :class:`~..ops.multifrontal.MFPlan` (the batched-front path for
    large cores; see that module's docs).
    """
    from .multifrontal import MFPlan, _mf_factor

    if isinstance(plan, MFPlan):
        return _mf_factor(plan, dc, w_pairs)
    dtype = dc.dtype
    # Initial off-diagonal values (−w of the core pairs) + one trailing
    # ZERO cell backing fill-slot and pad reads.
    init_ext = jnp.concatenate(
        [-w_pairs[jnp.asarray(plan.init_slot)].astype(dtype), jnp.zeros(1, dtype)]
    )
    # Update stream (see the _Round docstring): per-round Schur sums live
    # at static offsets; +1 trailing zero cell backs fold pads so reads
    # never re-append (which would copy the whole buffer each round).
    ustream = jnp.zeros(plan.mu_all + 1, dtype)
    d = dc
    rounds: list = []
    # Every reduction/update below is a gather-fold + inverse-map gather
    # (see _plan_fold) instead of scatter/segment_sum: exact tree sums in
    # a fixed order.
    # Slot values are never materialized as an (n_slots,) array: each
    # per-round op is proportional to that round's read/write sets.
    for rd in plan.rounds:
        e = jnp.asarray(rd.elim)
        a = init_ext[jnp.asarray(rd.init_idx)]  # (S, K); pads read zero
        if rd.u_read:
            a = a - _fold_apply_pre(ustream, rd.u_read).reshape(a.shape)
        inv = 1.0 / d[e]
        ainv = a * inv[:, None]
        s = _fold_apply((a * ainv).reshape(-1), rd.d_fold)
        s_ext = jnp.concatenate([s, jnp.zeros(1, dtype)])
        d = d - s_ext[jnp.asarray(rd.d_inv)]
        # off-diagonal Schur (fill) updates -> this round's stream segment
        if rd.u_src_i.size:
            contrib = a.reshape(-1)[jnp.asarray(rd.u_src_i)] * ainv.reshape(-1)[
                jnp.asarray(rd.u_src_j)
            ]
            su = _fold_apply(contrib, rd.u_fold)
            ustream = jax.lax.dynamic_update_slice(ustream, su, (rd.u_off,))
        rounds.append((a, inv))

    state: dict = {"rounds": tuple(rounds)}
    if plan.fronts:
        # multifrontal tail: dense f64 Cholesky per front,
        # Schur updates extend-added into the consuming front
        pending: dict[int, jnp.ndarray] = {}
        front_states: list = []
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
                # extend-add as a full (m, m) gather from the padded
                # update matrix (instead of a 2-D scatter of m_c²
                # elements); lminv maps F-local -> U-local or
                # the zero pad row/col.
                U = pending.pop(cid)
                Upad = jnp.pad(U, ((0, 1), (0, 1)))
                lmi = jnp.asarray(lminv)
                F = F + Upad[lmi[:, None], lmi[None, :]]
            C = jnp.linalg.cholesky(F[:w, :w])
            piv = jnp.diagonal(C)
            # zero-pivot gate (the MUMPS singularity analog): exact f64
            # factor, so only structural collapse trips it
            ok = ok & jnp.all(jnp.isfinite(piv)) & (
                jnp.min(piv) > 1e-12 * jnp.max(piv)
            )
            if b:
                X = jax.scipy.linalg.cho_solve((C, True), F[:w, w:])
                pending[fid] = F[w:, w:] - jnp.matmul(F[w:, :w], X, precision=_HI)
            else:
                X = None
            front_states.append((C, X))
        state["fronts"] = tuple(front_states)
        state["fronts_ok"] = ok
    if plan.dense_nodes.size:
        dn = jnp.asarray(plan.dense_nodes)
        Bd = int(plan.dense_nodes.size)
        Lc = jnp.zeros((Bd, Bd), dtype)
        Lc = Lc.at[jnp.arange(Bd), jnp.arange(Bd)].add(d[dn])
        if plan.dense_pairs.shape[0]:
            di = jnp.asarray(plan.dense_pairs[:, 0])
            dj = jnp.asarray(plan.dense_pairs[:, 1])
            ov = init_ext[jnp.asarray(plan.dp_init)]
            if plan.dp_fold:
                ov = ov - _fold_apply_pre(ustream, plan.dp_fold)
            Lc = Lc.at[di, dj].add(ov)
            Lc = Lc.at[dj, di].add(ov)
        # Jacobi-scaled f64 Cholesky (the shared dense-tail kernel)
        state["dense"] = scaled_cholesky_factor(Lc)
    return state


def _core_apply(
    plan: CoreElimPlan, state: dict, rc: jnp.ndarray
) -> jnp.ndarray:
    """Per-rhs half: forward rhs sweeps, dense-tail solve, back-substitution."""
    from .multifrontal import MFPlan, _mf_apply

    if isinstance(plan, MFPlan):
        return _mf_apply(plan, state, rc)
    dtype = rc.dtype
    Bc = plan.n_core
    r = rc
    saved: list = []
    for rd, (a, inv) in zip(plan.rounds, state["rounds"]):
        e = jnp.asarray(rd.elim)
        rv = r[e]
        ainv = a * inv[:, None]
        s = _fold_apply((ainv * rv[:, None]).reshape(-1), rd.d_fold)
        s_ext = jnp.concatenate([s, jnp.zeros(1, dtype)])
        r = r - s_ext[jnp.asarray(rd.d_inv)]
        saved.append((e, jnp.asarray(rd.nbr_node), a, inv, rv))

    front_rv: list = []
    if plan.fronts:
        # multifrontal forward sweep: r_B -= X^T r_S, in front order
        for fr, (C, X) in zip(plan.fronts, state["fronts"]):
            rv_f = r[jnp.asarray(fr.nodes)]
            front_rv.append(rv_f)
            if X is not None:
                r = r.at[jnp.asarray(fr.bnd)].add(-jnp.matmul(X.T, rv_f, precision=_HI))

    lam = jnp.zeros(Bc + 1, dtype)  # +1: padded neighbour reads
    if plan.dense_nodes.size:
        dn = jnp.asarray(plan.dense_nodes)
        lam_d = scaled_cholesky_solve(state["dense"], r[dn])
        lam = lam.at[dn].set(lam_d)

    if plan.fronts:
        for fr, (C, X), rv_f in reversed(
            list(zip(plan.fronts, state["fronts"], front_rv))
        ):
            lam_s = jax.scipy.linalg.cho_solve((C, True), rv_f)
            if X is not None:
                lam_s = lam_s - jnp.matmul(X, lam[jnp.asarray(fr.bnd)], precision=_HI)
            lam = lam.at[jnp.asarray(fr.nodes)].set(lam_s)
        # zero-pivot gate: poison the whole core solution so callers'
        # finiteness guards fail loudly (matching the dense-tail path)
        lam = jnp.where(state["fronts_ok"], lam, jnp.nan)

    for rd, (e, nbr, a, inv, rv) in zip(reversed(plan.rounds), reversed(saved)):
        lam_n = lam[nbr]  # (S, K); pads read lam[Bc] == 0
        new = (rv - jnp.sum(a * lam_n, axis=1)) * inv
        # scatter-set -> select + gather through the host inverse map
        new_ext = jnp.concatenate([new, jnp.zeros(1, dtype)])
        e_inv = jnp.asarray(rd.e_inv)
        lam = jnp.where(e_inv < e.shape[0], new_ext[e_inv], lam)
    return lam[:Bc]


def core_eliminate(
    plan: CoreElimPlan, dc: jnp.ndarray, rc: jnp.ndarray, w_pairs: jnp.ndarray
) -> jnp.ndarray:
    """Numeric phase: solve the core system ``(diag dc, offdiag −w) λ = rc``.

    ``dc``/``rc`` are the core-rank diagonal/rhs with all peeled
    contributions folded in; ``w_pairs`` the aggregated per-pair
    conductances (callers may have psum-reduced them).  Returns ``λ_core``
    (non-finite when the dense tail detects singularity, matching the
    dense core path's convention).  Internally split into
    :func:`_core_factor` (conductance side) and :func:`_core_apply`
    (per rhs) so factor-reuse serving shares the exact same formulas.
    """
    return _core_apply(plan, _core_factor(plan, dc, w_pairs), rc)
