"""Sharded lattice executor: the gather-free grid layout, multi-chip.

Uniform rectangular lattices (the ``make_grid`` capillary family) get the
same treatment the blocked forest path gives K-ary trees
(``blocked_sharded.py``): each device owns a horizontal STRIP of the λ
grid — ``h = ⌈ny / D⌉`` rows — plus every edge incident from it (its
x-edges, the y-edges sourced in it, and its boundary stubs), laid out so
per-device Schur assembly is a 2-D slice-add into a local ``(h+1, nx)``
window.  One ``psum`` of the window-placed rhs/diag grids replaces the
reference's ghost updates (MPI reverse-ADD, reference
``assembly.py:363-367``); the exact separable-DCT capacitance solve then
runs REPLICATED on every device (the λ grid is small — 2 MB at 512² —
while the edge data dominates memory), and the λ→edge expansion plus
back-substitution are purely local strip slices.

Per-solve cross-device traffic: two psums of the (ny_pad+1, nx) grids
plus two O(stubs) reductions — independent of N and the per-edge payload.

The executor returns the same 6-tuple contract as
:class:`blocked_sharded.ShardedBlockedExecutor` (``lam_T`` is empty and
``lam_src`` is the identity), so ``ShardedNetworkSolver._solve_blocked``
consumes both without branching.
"""

from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..solver import (
    _DctPlan,
    _blocked_condense,
    _dct_capacitance_solve,
    _plan_dct_lattice,
    _plan_grid_layout,
    _plan_shift_matvec,
)

try:  # jax >= 0.7 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

__all__ = [
    "ShardedGridPlan",
    "plan_sharded_grid",
    "build_sharded_grid_executor",
    "sharded_grid_sweep",
]

# row-table fields shipped sharded into the shard_map body
ROW_FIELDS = (
    "h_e", "valid", "s_is_bif", "t_is_bif", "stub_rel", "stub_grp",
    "stub_s_bif", "stub_valid",
)


class ShardedGridPlan(typing.NamedTuple):
    """Host-static plan for the strip-sharded lattice solve.

    Arrays with a leading ``D`` axis are sharded over the device mesh.
    Per-device slot layout: ``[x-edges (h, nx-1) row-major | y-edges
    (h, nx) row-major | stubs (st_cap)]`` where row ``i`` is global λ row
    ``d·h + i`` — invalid slots (rows ≥ ny, y-sources ≥ ny−1, stub pads)
    are inert (w = 0, zero contributions).
    """

    D: int
    nx: int
    ny: int
    h: int                    # λ rows per strip (⌈ny / D⌉)
    st_cap: int               # stub slots per device
    E_loc: int                # h*(nx-1) + h*nx + st_cap
    dct: "_DctPlan"
    edge_rows: np.ndarray     # (D, E_loc) public edge id, -1 pad
    h_e: np.ndarray           # (D, E_loc) cell lengths L/N (pad 1.0)
    valid: np.ndarray         # (D, E_loc)
    s_is_bif: np.ndarray      # (D, E_loc)
    t_is_bif: np.ndarray      # (D, E_loc)
    stub_rel: np.ndarray      # (D, st_cap) flat index into the (h+1, nx) window
    stub_grp: np.ndarray      # (D, st_cap) index into dct.stub_rows (0 pad)
    stub_s_bif: np.ndarray    # (D, st_cap)
    stub_valid: np.ndarray    # (D, st_cap)
    edge_flat: np.ndarray     # (E,) public edge -> row in the (D·E_loc) output
    lam_src: np.ndarray       # (B,) identity (λ comes back in node order)


def plan_sharded_grid(asm, D: int, modes: tuple | None = None) -> ShardedGridPlan | None:
    """Strip partition of a uniform lattice, or None outside the envelope.

    Envelope: scalar resistance + the :func:`_plan_dct_lattice` /
    :func:`_plan_grid_layout` structure checks (uniform rectangular
    multiplier grid, ≤ 16 stub rows).  ``modes`` overrides the live
    ``asm.coefficient_modes()`` when serving an assemble-time snapshot.
    """
    R_mode, _f_mode, _ = modes if modes is not None else asm.coefficient_modes()
    if R_mode != "scalar":
        return None
    shift_plan = _plan_shift_matvec(asm)
    if shift_plan is None:
        return None
    dct = _plan_dct_lattice(asm, shift_plan)
    if dct is None:
        return None
    gp = _plan_grid_layout(asm, dct)
    if gp is None:
        return None
    nx, ny = gp.nx, gp.ny
    mesh = asm.network
    E = mesh.num_edges
    h = -(-ny // D)  # ceil
    Ex_loc, Ey_loc = h * (nx - 1), h * nx
    # stubs by owning strip
    stub_pub = gp.edge_order[gp.Ex + gp.Ey:]
    stub_row = gp.stub_rows_e
    stub_dev = stub_row // nx // h  # strip owning the stub's λ row
    st_cap = int(np.max(np.bincount(stub_dev, minlength=D))) if stub_pub.size else 0
    E_loc = Ex_loc + Ey_loc + st_cap

    edge_rows = np.full((D, E_loc), -1, dtype=np.int64)
    h_e = np.ones((D, E_loc))
    valid = np.zeros((D, E_loc), dtype=bool)
    s_b = np.zeros((D, E_loc), dtype=bool)
    t_b = np.zeros((D, E_loc), dtype=bool)
    stub_rel = np.zeros((D, st_cap), dtype=np.int64)
    stub_grp = np.zeros((D, st_cap), dtype=np.int64)
    stub_sb = np.zeros((D, st_cap), dtype=bool)
    stub_val = np.zeros((D, st_cap), dtype=bool)

    h_cells = np.asarray(mesh.edge_length) / mesh.N
    x_pub = gp.edge_order[: gp.Ex].reshape(ny, nx - 1)
    y_pub = gp.edge_order[gp.Ex : gp.Ex + gp.Ey].reshape(ny - 1, nx)
    for d in range(D):
        y0 = d * h
        rows_x = min(max(ny - y0, 0), h)
        if rows_x > 0:
            sl = slice(0, rows_x * (nx - 1))
            ids = x_pub[y0 : y0 + rows_x].reshape(-1)
            edge_rows[d, sl] = ids
            h_e[d, sl] = h_cells[ids]
            valid[d, sl] = True
            s_b[d, sl] = True
            t_b[d, sl] = True
        rows_y = min(max(ny - 1 - y0, 0), h)
        if rows_y > 0:
            sl = slice(Ex_loc, Ex_loc + rows_y * nx)
            ids = y_pub[y0 : y0 + rows_y].reshape(-1)
            edge_rows[d, sl] = ids
            h_e[d, sl] = h_cells[ids]
            valid[d, sl] = True
            s_b[d, sl] = True
            t_b[d, sl] = True
        mine = np.nonzero(stub_dev == d)[0]
        for j, t in enumerate(mine):
            slot = Ex_loc + Ey_loc + j
            pub = int(stub_pub[t])
            edge_rows[d, slot] = pub
            h_e[d, slot] = h_cells[pub]
            valid[d, slot] = True
            s_b[d, slot] = bool(gp.stub_s_bif[t])
            t_b[d, slot] = not gp.stub_s_bif[t]
            stub_rel[d, j] = int(stub_row[t]) - y0 * nx
            stub_grp[d, j] = int(gp.stub_group[t])
            stub_sb[d, j] = bool(gp.stub_s_bif[t])
            stub_val[d, j] = True

    edge_flat = np.empty(E, dtype=np.int64)
    rows_all = edge_rows.reshape(-1)
    pos = np.nonzero(rows_all >= 0)[0]
    edge_flat[rows_all[pos]] = pos
    B = mesh.num_multipliers
    return ShardedGridPlan(
        D=D, nx=nx, ny=ny, h=h, st_cap=st_cap, E_loc=E_loc, dct=dct,
        edge_rows=edge_rows, h_e=h_e, valid=valid, s_is_bif=s_b,
        t_is_bif=t_b, stub_rel=stub_rel, stub_grp=stub_grp,
        stub_s_bif=stub_sb, stub_valid=stub_val, edge_flat=edge_flat,
        lam_src=np.arange(B, dtype=np.int64),
    )


class ShardedGridExecutor:
    """Callable wrapper mirroring :class:`ShardedBlockedExecutor`.

    Returns ``(q_T (m, D·E_loc), p_T (N, D·E_loc), lam (B,),
    lam_T (0,), residual, rhs_norm, finite)``.
    """

    method_name = "schur_sharded_grid"

    def __init__(self, fn, plan: ShardedGridPlan, mesh, axis: str,
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
        ok = rows >= 0
        rv = np.maximum(rows, 0)

        def per_edge(a, mode, pad):
            a = np.asarray(a)
            if mode == "scalar":
                a = np.broadcast_to(a.reshape(-1)[:1], (rows.size,))
                return np.where(ok, a, pad)
            if mode == "cell":
                cells = a.reshape(-1, self._N)[rv].T  # (N, rows)
                return np.where(ok[None, :], cells, pad)
            return np.where(ok, a[rv], pad)

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


def _make_grid_local_body(asm, plan, axis: str, dtype):
    """Per-device strip-solve body (closure over the static plan).

    Shared by :func:`build_sharded_grid_executor` (1-D edge mesh) and
    :func:`sharded_grid_sweep` (2-D scenarios x edges mesh, vmapped
    over the local scenario chunk)."""
    N, k = asm.network.N, asm.flux_degree
    nx, ny, h, D = plan.nx, plan.ny, plan.h, plan.D
    Ex_loc, Ey_loc, st_cap, E_loc = (
        h * (nx - 1), h * nx, plan.st_cap, plan.E_loc
    )
    ny_pad = D * h
    dct = plan.dct
    r_dct = int(dct.stub_rows.size)
    B = ny * nx
    def local_solve(R_e, f_e, spbc, epbc, rows):
        h_cells = rows["h_e"].reshape(-1).astype(dtype)
        ok = rows["valid"].reshape(-1)
        s_b = rows["s_is_bif"].reshape(-1)
        t_b = rows["t_is_bif"].reshape(-1)
        R_e = R_e.astype(dtype)
        f_e = f_e.astype(dtype)
        spbc = spbc.astype(dtype)
        epbc = epbc.astype(dtype)
        d_idx = jax.lax.axis_index(axis)

        W, g, Ftot, back = _blocked_condense(
            N, E_loc, h_cells, R_e, f_e,
            "cell" if R_e.ndim == 2 else "edge",
            "cell" if f_e.ndim == 2 else "edge",
            k=k,
        )
        w = jnp.where(ok, 1.0 / W, 0.0)
        const = (-spbc * (~s_b) + epbc * (~t_b) - g) * w
        cF = const + Ftot

        cF_x = cF[:Ex_loc].reshape(h, nx - 1)
        co_x = const[:Ex_loc].reshape(h, nx - 1)
        w_x = w[:Ex_loc].reshape(h, nx - 1)
        cF_y = cF[Ex_loc : Ex_loc + Ey_loc].reshape(h, nx)
        co_y = const[Ex_loc : Ex_loc + Ey_loc].reshape(h, nx)
        w_y = w[Ex_loc : Ex_loc + Ey_loc].reshape(h, nx)

        # local (h+1, nx) strip windows: row i is global λ row d·h + i
        strip_r = jnp.zeros((h + 1, nx), dtype)
        strip_r = strip_r.at[:h, 1:].add(cF_x)
        strip_r = strip_r.at[:h, : nx - 1].add(-co_x)
        strip_r = strip_r.at[1:, :].add(cF_y)
        strip_r = strip_r.at[:h, :].add(-co_y)
        strip_d = jnp.zeros((h + 1, nx), dtype)
        strip_d = strip_d.at[:h, : nx - 1].add(w_x)
        strip_d = strip_d.at[:h, 1:].add(w_x)
        strip_d = strip_d.at[:h, :].add(w_y)
        strip_d = strip_d.at[1:, :].add(w_y)
        w_r = jnp.zeros(r_dct, dtype)
        if st_cap:
            st_rel = rows["stub_rel"].reshape(-1)
            st_grp = rows["stub_grp"].reshape(-1)
            st_sb = rows["stub_s_bif"].reshape(-1)
            st_ok = rows["stub_valid"].reshape(-1)
            w_st = w[Ex_loc + Ey_loc :]
            cF_st = cF[Ex_loc + Ey_loc :]
            co_st = const[Ex_loc + Ey_loc :]
            rhs_st = jnp.where(st_sb, -co_st, cF_st) * st_ok
            strip_r = strip_r.reshape(-1).at[st_rel].add(rhs_st).reshape(h + 1, nx)
            strip_d = strip_d.reshape(-1).at[st_rel].add(w_st * st_ok).reshape(h + 1, nx)
            w_r = w_r.at[st_grp].add(w_st * st_ok)
            w_r = jax.lax.psum(w_r, axis)

        # ghost-update analog: place the window at the strip offset and
        # psum — each interior row receives contributions from exactly the
        # two neighboring strips (the reference's MPI reverse-ADD,
        # assembly.py:363-367)
        def placed(strip):
            full = jnp.zeros((ny_pad + 1, nx), dtype)
            full = jax.lax.dynamic_update_slice(full, strip, (d_idx * h, jnp.zeros((), d_idx.dtype)))
            return jax.lax.psum(full, axis)

        rhs2 = placed(strip_r)[:ny]
        diag2 = placed(strip_d)[:ny]
        rhs = rhs2.reshape(-1)

        # replicated exact DCT capacitance solve.  Scalar R ⇒ uniform
        # per-direction CONDENSED conductances (1/W carries the flux-degree
        # condensation factor — serial core uses w[0]/w[Ex] identically);
        # device 0 owns row 0, hence both representative slots.
        on_dev0 = (d_idx == 0).astype(dtype)
        wx = jax.lax.psum(on_dev0 * w[0], axis)
        wy = jax.lax.psum(on_dev0 * w[Ex_loc], axis)

        def matvec(lam):
            l2 = lam.reshape(ny, nx)
            out = diag2 * l2
            out = out.at[:, : nx - 1].add(-wx * l2[:, 1:])
            out = out.at[:, 1:].add(-wx * l2[:, : nx - 1])
            out = out.at[: ny - 1, :].add(-wy * l2[1:, :])
            out = out.at[1:, :].add(-wy * l2[: ny - 1, :])
            return out.reshape(-1)

        lam = _dct_capacitance_solve(dct, wx, wy, w_r, rhs, matvec)

        # local λ window (h+1 rows starting at the strip offset)
        lam_pad = jnp.zeros((ny_pad + 1) * nx, dtype).at[:B].set(lam)
        win = jax.lax.dynamic_slice(
            lam_pad.reshape(ny_pad + 1, nx), (d_idx * h, jnp.zeros((), d_idx.dtype)), (h + 1, nx)
        )
        parts_s = [win[:h, : nx - 1].reshape(-1), win[:h, :].reshape(-1)]
        parts_t = [win[:h, 1:].reshape(-1), win[1:, :].reshape(-1)]
        if st_cap:
            lam_st = win.reshape(-1)[st_rel]
            parts_s.append(jnp.where(st_sb, lam_st, 0.0))
            parts_t.append(jnp.where(st_sb, 0.0, lam_st))
        lam_s = jnp.concatenate(parts_s)
        lam_t = jnp.concatenate(parts_t)

        r0 = jnp.where(s_b, lam_s, -spbc)
        rN = jnp.where(t_b, -lam_t, epbc)
        q0 = (r0 + rN - g) * w
        q_T, p_T = back(q0, r0)
        res = jnp.linalg.norm(matvec(lam) - rhs)
        rhs_norm = jnp.linalg.norm(rhs)
        fin_loc = (
            jnp.all(jnp.isfinite(q0))
            & jnp.all(jnp.isfinite(r0))
            & jnp.all(jnp.isfinite(lam))
        )
        finite = jax.lax.psum(fin_loc.astype(jnp.int32), axis) == jnp.asarray(
            D, jnp.int32
        )
        # Surface the λ-system residual through SolveInfo.residual,
        # matching the serial grid core's contract (the transform is
        # f64-exact at every width; the residual proves it per solve).
        return (
            q_T.astype(dtype),
            p_T.astype(dtype),
            lam.astype(dtype),
            jnp.zeros(0, dtype),
            res,
            rhs_norm,
            finite,
        )

    return local_solve


def build_sharded_grid_executor(
    asm, plan: ShardedGridPlan, mesh, axis: str, dtype=jnp.float64,
    modes: tuple | None = None,
) -> ShardedGridExecutor:
    """Trace + jit the strip-sharded lattice shard_map pipeline.

    ``modes`` overrides the live ``asm.coefficient_modes()`` when serving
    an assemble-time coefficient snapshot.
    """
    R_mode, f_mode, _ = modes if modes is not None else asm.coefficient_modes()
    if f_mode not in ("scalar", "edge", "cell"):
        raise ValueError(
            "sharded grid executor requires scalar/per-edge/per-cell f"
        )
    local_solve = _make_grid_local_body(asm, plan, axis, dtype)
    spec_e = P(axis)
    spec_c = P(None, axis)
    in_specs = (
        spec_c if R_mode == "cell" else spec_e,
        spec_c if f_mode == "cell" else spec_e,
        spec_e, spec_e,
        {f: spec_e for f in ROW_FIELDS},
    )
    # λ / scalars are replicated by construction (psum-reduced inputs +
    # identical replicated solve); vma checking can't see through the
    # DCT/capacitance chain — replication is pinned numerically by
    # tests/test_grid_sharded.py instead.
    out_specs = (P(None, axis), P(None, axis), P(), P(), P(), P(), P())
    fn = shard_map(
        local_solve, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return ShardedGridExecutor(
        jax.jit(fn), plan, mesh, axis, R_mode, f_mode, N=asm.network.N
    )


def sharded_grid_sweep(
    asm,
    plan: ShardedGridPlan,
    R_scalars: "np.ndarray",
    mesh2d,
    batch_axis: str = "batch",
    edge_axis: str = "edges",
    dtype=jnp.float64,
):
    """2-D (scenarios × strips) lattice sweep through the exact DCT solve.

    The scenario axis is data-parallel over ``batch_axis`` devices; within
    each batch group the strip-sharded grid body runs over ``edge_axis``
    devices, ``vmap``-ped over the local scenario chunk (its psums batch
    over the edge axis).  Scenarios vary the SCALAR resistance — the DCT
    envelope (per-edge R disqualifies the separable transform, exactly as
    in the serial executor); f and the boundary pressures are those of the
    assembler's computed forms.

    Returns ``(x, (inputs, outputs))``: ``x (S, num_dofs)`` host array in
    the public layout, and the program's sharded device arrays.
    """
    R_mode, f_mode, _ = asm.coefficient_modes()
    if R_mode != "scalar":
        raise ValueError(
            "sharded_grid_sweep requires scalar resistance scenarios "
            "(the separable-DCT envelope)"
        )
    Db = mesh2d.shape[batch_axis]
    De = mesh2d.shape[edge_axis]
    if De != plan.D:
        raise ValueError(f"plan was built for {plan.D} strip devices, mesh has {De}")

    R_scalars = np.asarray(R_scalars, dtype=np.float64)
    if R_scalars.ndim != 1:
        # A (S, E) per-edge scenario matrix must not silently become
        # S*E scalar scenarios — per-edge R disqualifies the DCT anyway.
        raise ValueError(
            "sharded_grid_sweep takes a 1-D array of SCALAR resistance "
            f"scenarios, got shape {R_scalars.shape}; per-edge scenario "
            "matrices are served by the general sharded sweep"
        )
    S = R_scalars.size
    S_pad = (-S) % Db
    R_all = np.concatenate([R_scalars, np.ones(S_pad)])

    # fixed per-row args: unit-R rows scale linearly per scenario (pad
    # slots are masked / sliced off inside the body, so the pad value is
    # inert under scaling)
    meta = ShardedGridExecutor(
        None, plan, mesh2d, edge_axis, R_mode, f_mode, N=asm.network.N
    )
    base = asm.schur_arguments(device=False)
    R_unit, f_rows, sp_rows, ep_rows = meta.prepare_args(
        np.ones(1), base[1], base[2], base[3]
    )
    rows_dev = {f: jnp.asarray(getattr(plan, f)) for f in ROW_FIELDS}

    body = _make_grid_local_body(asm, plan, edge_axis, dtype)

    def local(R_chunk, Ru, f_e, spbc, epbc, rows):
        return jax.vmap(
            lambda rs: body(rs * Ru, f_e, spbc, epbc, rows)
        )(R_chunk)

    spec_b = P(batch_axis)
    spec_e = P(edge_axis)
    spec_c = P(None, edge_axis)
    in_specs = (
        spec_b,
        spec_e,  # unit R rows are per-edge by construction
        spec_c if f_mode == "cell" else spec_e,
        spec_e,
        spec_e,
        {f: spec_e for f in ROW_FIELDS},
    )
    out_specs = (
        P(batch_axis, None, edge_axis),  # q_T (S, m, D_e*E_loc)
        P(batch_axis, None, edge_axis),  # p_T
        P(batch_axis),  # lam (S, B) — replicated over strips
        P(batch_axis),  # lam_T (S, 0)
        P(batch_axis),  # residual
        P(batch_axis),  # rhs_norm
        P(batch_axis),  # finite
    )
    fn = jax.jit(
        shard_map(
            local, mesh=mesh2d, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    )
    sh_b = NamedSharding(mesh2d, spec_b)
    sh_e = NamedSharding(mesh2d, spec_e)
    sh_f = NamedSharding(mesh2d, spec_c if f_mode == "cell" else spec_e)
    ins = (
        jax.device_put(jnp.asarray(R_all), sh_b),
        jax.device_put(jnp.asarray(R_unit), sh_e),
        jax.device_put(jnp.asarray(f_rows), sh_f),
        jax.device_put(jnp.asarray(sp_rows), sh_e),
        jax.device_put(jnp.asarray(ep_rows), sh_e),
        jax.device_put(rows_dev, {f: sh_e for f in rows_dev}),
    )
    outs = fn(*ins)
    from .sharding import _to_host

    q_T, p_T, lam, _lam_T, _res, _rhs_n, finite = outs

    if not bool(np.all(_to_host(finite)[:S])):
        raise RuntimeError(
            "Solver did not converge: sharded grid sweep produced "
            "non-finite values"
        )

    q = np.swapaxes(_to_host(q_T), 1, 2)[:S]  # (S, D_e*E_loc, m)
    p = np.swapaxes(_to_host(p_T), 1, 2)[:S]
    q_edge = q[:, plan.edge_flat]
    p_cells = p[:, plan.edge_flat]
    lam_h = _to_host(lam)[:S][:, plan.lam_src]

    from .sharding import _scatter_blocks_to_x

    return _scatter_blocks_to_x(asm, q_edge, p_cells, lam_h), (ins, outs)
