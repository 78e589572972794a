"""Edge-partitioned multi-device execution via ``shard_map``.

Replacement for the reference's MPI-SPMD domain decomposition:
the reference scatters mesh cells across ranks with ParMETIS/SCOTCH and
shared-facet ghosting (reference ``mesh.py:331-348``), broadcasts graph
metadata (``mesh.py:227-250``) and reconciles shared rows with reverse-ADD /
forward-INSERT ghost updates (``assembly.py:363-367``, ``solver.py:128-132``).

Here the network's edge axis is sharded across a ``jax.sharding.Mesh``.
Every per-edge quantity (condensed cell masses, chain cumsums, boundary
data) lives on the device that owns the edge; the only cross-device coupling
is the bifurcation Schur system, whose per-device scatter contributions are
reduced with a single ``psum`` over the device mesh — the collective that
replaces ghost updates.  The (small, replicated) SPD Laplacian is then
factorised identically on every device and back-substitution is purely
local.  Graph metadata needs no broadcast: it is baked into the jitted
program by the single controller.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import assembly as _assembly
from ..function import NetworkFunction
from ..ops import krylov
from ..ops.scaled_cholesky import scaled_cholesky_factor, scaled_cholesky_solve
from ..solver import (
    SolveInfo,
    _EdgeData,
    _backsub_from_lambda,
    _plan_level_elimination,
    _plan_tree_elimination,
    _prepare_edge_data,
)
from ..utils.timing import timed

try:  # jax >= 0.7 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

__all__ = ["ShardedNetworkSolver", "shard_solve", "make_device_mesh"]

# distributed λ elimination kicks in automatically above this multiplier
# count (below it the replicated elimination is cheaper than the extra
# plumbing; above it per-device O(B) memory/work caps scaling)
_DIST_LAMBDA_THRESHOLD = 4096


def make_device_mesh(devices=None, axis_name: str = "edges") -> Mesh:
    """1D device mesh over which the edge axis is partitioned."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), axis_names=(axis_name,))


def _to_host(x) -> np.ndarray:
    """Device→host pull that also works under multi-controller execution.

    Single-process (including the virtual CPU mesh): a plain
    ``np.asarray``.  Multi-process (``jax.distributed`` across hosts — the
    reference's ``mpiexec`` analog): an array sharded across processes is
    not fully addressable and must be gathered first (the reference's
    forward-INSERT ghost update on the solution, ``solver.py:128-132``).
    """
    if isinstance(x, jax.Array) and not (
        x.is_fully_addressable or x.is_fully_replicated
    ):
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


def _scatter_blocks_to_x(asm, q_edge, p_cells, lam) -> np.ndarray:
    """Public-layout global vector(s) from per-edge solution rows.

    ``q_edge (..., E, k*N+1)`` per-edge flux rows (public edge order),
    ``p_cells (..., E, N)`` / ``(..., C)`` pressure cells (mesh cell
    order), ``lam (..., B)`` multipliers → ``x (..., num_dofs)`` in the
    reference's block layout ``[q_color_0.. | p | λ]`` (flux placement via
    ``asm._edge_flux_base``, which already encodes the color sort).
    Leading batch axes broadcast — the single shared implementation of
    the scatter previously copy-pasted across the sharded executors."""
    net = asm.network
    q_edge = np.asarray(q_edge)
    batch = q_edge.shape[:-2]
    x = np.zeros(batch + (asm.num_dofs,))
    dofs_per_edge = asm.flux_degree * net.N + 1
    idx = asm._edge_flux_base[:, None] + np.arange(dofs_per_edge)[None, :]
    x[..., idx.reshape(-1)] = q_edge.reshape(batch + (-1,))
    p_off = int(asm.block_offsets[net.num_edge_colors])
    x[..., p_off : p_off + net.num_cells] = np.asarray(p_cells).reshape(
        batch + (-1,)
    )
    x[..., asm._lm_offset :] = np.asarray(lam)
    return x


def _edge_specs(ed: _EdgeData, spec_e, spec_rep):
    """Per-leaf shard_map specs/shardings for an edge-data pytree.

    Every leaf shards along the edge axis, except the degree-k scalar
    layout's FIXED scale-free ``(k-1, 2)`` interior recovery matrix
    (:func:`networks_fenicsx_tpu.solver._condensed_scalar_constants`),
    which has no edge axis and is replicated — broadcasting it per-cell
    instead would re-materialise the O(C) tensor the layout eliminates."""
    specs = jax.tree.map(lambda _: spec_e, ed)
    if ed.interior and ed.interior[0].ndim == 2:
        specs = specs._replace(interior=(spec_rep,))
    return specs


def _pad_edge_data(ed: _EdgeData, n_pad: int, n_cells: int = 1) -> _EdgeData:
    """Append inert edges so the edge count divides the device count.

    Padding edges have unit resistance, no source, no bifurcation and zero
    boundary pressure — they solve to exactly zero flux/pressure and
    contribute nothing to the Schur system.  Handles all three edge-data
    layouts (general ``mt``, scalar ``rh``, uniform ``ua``/``uF`` — see
    :class:`networks_fenicsx_tpu.solver._EdgeData`); the pad values keep
    each layout's internal identities (W = Σa, g = 0, cumF = 0) intact.
    """
    if n_pad == 0:
        return ed
    N = ed.cumF.shape[1] - 1 if ed.ua is None else n_cells
    dt = ed.W.dtype

    def cat(a, b):
        return jnp.concatenate([a, b], axis=0)

    interior = ed.interior
    k = 1
    if interior:
        (Minv_IE,) = interior
        km1 = Minv_IE.shape[-2]
        k = km1 + 1
        if Minv_IE.ndim == 3:
            interior = (cat(Minv_IE, jnp.zeros((n_pad * N, km1, 2), dt)),)
        # ndim == 2: fixed scale-free recovery matrix — shared by pad edges
    if ed.ua is not None:
        # uniform layout: pad a=1 ⇒ W = a·N keeps the layout identity;
        # cumF holds only the Ftot column in this layout
        mt = None
        rh = None
        ua = cat(ed.ua, jnp.ones(n_pad, dt))
        uF = cat(ed.uF, jnp.zeros(n_pad, dt))
        W_pad = jnp.full(n_pad, float(N), dt)
        cumF_pad = jnp.zeros((n_pad, ed.cumF.shape[1]), dt)
    else:
        ua = uF = None
        if ed.mt is not None:
            eye = jnp.broadcast_to(jnp.eye(2, dtype=dt) * 0.5, (n_pad, N, 2, 2))
            mt = cat(ed.mt, eye)
            rh = None
        else:
            mt = None
            rh = cat(ed.rh, jnp.full((n_pad, N), 1.0 / N, dt))
        if mt is None and k > 1:
            # scalar degree-k layout: W = w̃·Σa, so the unit-resistance
            # pad edge carries W = w̃ (w̃ = 1 for P1)
            from ..solver import _condensed_scalar_constants

            W_pad = jnp.full(n_pad, _condensed_scalar_constants(k)[2], dt)
        else:
            W_pad = jnp.ones(n_pad, dt)
        cumF_pad = jnp.zeros((n_pad, N + 1), dt)
    return _EdgeData(
        mt=mt,
        cumF=cat(ed.cumF, cumF_pad),
        W=cat(ed.W, W_pad),
        g=cat(ed.g, jnp.zeros(n_pad, dt)),
        start_bif=cat(ed.start_bif, -jnp.ones(n_pad, ed.start_bif.dtype)),
        end_bif=cat(ed.end_bif, -jnp.ones(n_pad, ed.end_bif.dtype)),
        start_pbc=cat(ed.start_pbc, jnp.zeros(n_pad, dt)),
        end_pbc=cat(ed.end_pbc, jnp.zeros(n_pad, dt)),
        interior=interior,
        rh=rh,
        ua=ua,
        uF=uF,
    )


def _distributed_tree_pipeline(
    mesh: Mesh, axis: str, plan, k: int, N: int, ed_template: _EdgeData
):
    """shard_map pipeline with the λ elimination itself distributed: local
    subtree elimination per device + one psum of the tiny replicated top
    system (see :mod:`.distributed_tree`)."""
    from .distributed_tree import local_eliminate, plan_rows

    B_loc = plan.B_loc

    def local_solve(ed: _EdgeData, rows: dict):
        lam_all = local_eliminate(plan, rows, ed, axis)
        q_edge, p_cells = _backsub_from_lambda(ed, lam_all, k, N)
        return q_edge, p_cells, lam_all[:B_loc], lam_all[B_loc:]

    spec_e = P(axis)
    in_specs = (
        _edge_specs(ed_template, spec_e, P()),
        {key: spec_e for key in plan_rows(plan)},
    )
    out_specs = (spec_e, spec_e, spec_e, P())  # λ_T replicated
    # λ_T is replicated by construction (psum-reduced inputs + identical
    # dense solve on every device); the static vma checker cannot see
    # through the scatter/cholesky chain, so the check is disabled and
    # replication is instead pinned numerically by tests/test_sharding.py
    # (sharded == serial at 1e-10).
    fn = shard_map(
        local_solve,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def _sharded_schur_pipeline(
    mesh: Mesh,
    axis: str,
    B: int,
    k: int,
    N: int,
    schur_method: str = "auto",
    tree_plan=None,
    level_plan=None,
    *,
    ed_template: _EdgeData,
):
    """Build the jitted shard_map solve: edge shards in → solution shards
    out.  ``ed_template`` (required) supplies the edge-data pytree whose
    structure defines the shard_map in_specs — layouts vary (general /
    scalar / uniform), so the specs cannot be hardcoded."""
    if schur_method == "auto":
        if tree_plan is not None and (
            tree_plan.core_size <= 4096 or tree_plan.core_plan is not None
        ):
            schur_method = "tree"
        else:
            schur_method = "dense" if B <= 4096 else "cg"

    def local_solve(ed: _EdgeData, edge_pair: jnp.ndarray):
        if B == 0:  # no bifurcations: edges decouple entirely
            lam = jnp.zeros(0, dtype=ed.W.dtype)
            q_edge, p_cells = _backsub_from_lambda(ed, lam, k, N)
            return q_edge, p_cells, lam
        # --- local Schur contributions (replaces reverse-ADD ghost update)
        w = 1.0 / ed.W
        s_is_bif = ed.start_bif >= 0
        t_is_bif = ed.end_bif >= 0
        s_idx = jnp.where(s_is_bif, ed.start_bif, 0)
        t_idx = jnp.where(t_is_bif, ed.end_bif, 0)
        const = (-ed.start_pbc * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
        Ftot = ed.cumF[:, -1]

        rhs = jnp.zeros(B, dtype=ed.W.dtype)
        rhs = rhs.at[t_idx].add(jnp.where(t_is_bif, const + Ftot, 0.0))
        rhs = rhs.at[s_idx].add(jnp.where(s_is_bif, -const, 0.0))
        rhs = jax.lax.psum(rhs, axis)

        diag = jnp.zeros(B, dtype=ed.W.dtype)
        diag = diag.at[t_idx].add(jnp.where(t_is_bif, w, 0.0))
        diag = diag.at[s_idx].add(jnp.where(s_is_bif, w, 0.0))
        diag = jax.lax.psum(diag, axis)
        both = s_is_bif & t_is_bif
        off_w = jnp.where(both, w, 0.0)

        if schur_method == "tree":
            # Aggregate per-pair conductances from device-local edges with
            # one psum, then run the (replicated) fill-in-free elimination:
            # the scatter-free level ordering for forests, peel-then-core
            # otherwise.
            from ..solver import _level_eliminate_core, _tree_eliminate

            P_pairs = tree_plan.pair_nodes.shape[0]
            sel = edge_pair >= 0
            pid = jnp.where(sel, edge_pair, 0)
            w_local = jnp.zeros(P_pairs, dtype=ed.W.dtype)
            w_local = w_local.at[pid].add(jnp.where(sel, w, 0.0))
            w_pairs = jax.lax.psum(w_local, axis)
            if level_plan is not None:
                inv = jnp.asarray(level_plan.inv_perm)
                lam = _level_eliminate_core(
                    level_plan, diag[inv], rhs[inv], w_pairs, B
                )
            else:
                lam = _tree_eliminate(tree_plan, diag, rhs, w_pairs)
        elif schur_method == "dense":
            # --- psum the partial Laplacian; replicated Jacobi-scaled
            # Cholesky (identical on every device, avoids a broadcast).
            L = jnp.zeros((B, B), dtype=ed.W.dtype)
            L = L.at[s_idx, t_idx].add(-off_w)
            L = L.at[t_idx, s_idx].add(-off_w)
            L = jax.lax.psum(L, axis)
            L = L.at[jnp.arange(B), jnp.arange(B)].add(diag)
            # shared Jacobi-scaled Cholesky, INCLUDING the singularity
            # pivot gate (NaN out, so the caller's non-finite guard raises
            # just like the serial dense path)
            lam = scaled_cholesky_solve(scaled_cholesky_factor(L), rhs)
        else:
            # --- distributed matrix-free CG: the off-diagonal apply is a
            # local gather/scatter over owned edges + one psum per
            # iteration; iterates stay bitwise-identical on every device.
            def matvec(lam):
                local = jnp.zeros(B, dtype=ed.W.dtype)
                local = local.at[s_idx].add(-off_w * lam[t_idx])
                local = local.at[t_idx].add(-off_w * lam[s_idx])
                return diag * lam + jax.lax.psum(local, axis)

            result = krylov.cg(
                matvec, rhs, precond=lambda v: v / diag, rtol=1e-13
            )
            lam = result.x

        # --- purely local back-substitution on owned edges
        q_edge, p_cells = _backsub_from_lambda(ed, lam, k, N)
        return q_edge, p_cells, lam

    spec_e = P(axis)
    in_specs = _edge_specs(ed_template, spec_e, P())
    out_specs = (spec_e, spec_e, P())  # λ replicated
    fn = shard_map(
        local_solve, mesh=mesh, in_specs=(in_specs, spec_e), out_specs=out_specs
    )
    return jax.jit(fn)


class ShardedNetworkSolver:
    """Multi-device Schur solver with the edge axis partitioned over a mesh.

    Usage mirrors :class:`networks_fenicsx_tpu.Solver`:

    >>> solver = ShardedNetworkSolver(assembler, devices=jax.devices())
    >>> solver.assemble()
    >>> functions = solver.solve()

    Requires discontinuous (degree-0) pressure, like the serial Schur path.
    """

    def __init__(
        self,
        assembler: _assembly.HydraulicNetworkAssembler,
        devices=None,
        axis_name: str = "edges",
        schur_method: str = "auto",
    ):
        if assembler.pressure_degree != 0:
            raise ValueError("sharded solver requires degree-0 pressure")
        self._assembler = assembler
        self._mesh = make_device_mesh(devices, axis_name)
        self._axis = axis_name
        self._schur_method = schur_method
        self._edge_data: _EdgeData | None = None
        self._pipeline = None
        self._tree_plan = None
        self._dist_plan = None
        self._blocked_exec = None
        self._blocked_checked: tuple | None = None
        self._asm_modes_key: tuple | None = None
        self._info: SolveInfo | None = None
        # (inputs, outputs) device arrays of the last solve's sharded
        # program, so a caller can see which devices held them
        self.device_io: tuple | None = None

    @property
    def device_mesh(self) -> Mesh:
        return self._mesh

    @property
    def info(self) -> SolveInfo | None:
        return self._info

    def assemble(self, lhs: bool = True, rhs: bool = True) -> None:
        del lhs, rhs
        self._edge_data = _prepare_edge_data(self._assembler)
        # Snapshot the coefficient buffers: like the reference
        # (``solver.py:90-101``), solve() uses the state captured at
        # assemble() time — a compute_forms() call between assemble() and
        # solve() takes effect only after the next assemble(), uniformly
        # across the blocked and general paths.
        self._coeff_args = tuple(
            np.array(a, copy=True)
            for a in self._assembler.schur_arguments(device=False)
        )
        # The coefficient KINDS at snapshot time — executor selection must
        # be keyed on these, not on solve-time coefficient_modes(): a
        # compute_forms() call between assemble() and solve() that changes
        # a kind (e.g. per-edge R -> scalar) must not pair a new-mode
        # executor with the old-kind snapshot buffers.
        self._asm_modes_key = self._assembler.coefficient_modes()

    @timed("nxfx:ShardedSolver:solve", block=True)
    def solve(self, functions: list[NetworkFunction] | None = None) -> list[NetworkFunction]:
        asm = self._assembler
        net = asm.network
        if net.has_floating_component():
            raise RuntimeError(
                "Solver did not converge: network has a component with no "
                "boundary node — the system is singular"
            )
        if self._edge_data is None:
            self.assemble()
        D = int(np.prod([self._mesh.shape[a] for a in self._mesh.axis_names]))
        E = net.num_edges

        # --- blocked-sibling sharded fast path: identically-shaped
        # per-device subforests run the serial blocked slice/concat
        # program; cross-device coupling is one psum of the tiny top tree.
        # Keyed on the ASSEMBLE-time coefficient modes (snapshotted with
        # the coefficient buffers): a compute_forms() call that changes the
        # coefficient KINDS (e.g. per-edge -> scalar R) takes effect at the
        # next assemble(), like the reference's KSP semantics — solving
        # with a new-mode executor against old-kind snapshot buffers would
        # silently broadcast the wrong coefficients.
        modes_key = self._asm_modes_key
        if getattr(self, "_modes_key", None) != modes_key:
            # coefficient kinds changed: the edge-data layout (and hence
            # the traced shard_map signature) may differ — drop the traced
            # pipeline (the topology-only _dist_plan stays valid)
            self._modes_key = modes_key
            self._pipeline = None
        if self._blocked_checked != modes_key and self._schur_method in ("auto", "blocked"):
            self._blocked_checked = modes_key
            self._blocked_exec = None
            R_mode, f_mode, _ = modes_key
            if R_mode in ("scalar", "edge", "cell") and f_mode in (
                "scalar", "edge", "cell"
            ):
                # any flux degree: the blocked condensation carries the
                # fixed condensed-constant forms (_condensed_scalar_constants)
                from .blocked_sharded import (
                    build_sharded_blocked_executor,
                    plan_sharded_blocked,
                )

                plan = plan_sharded_blocked(asm, D)
                if plan is not None:
                    self._blocked_exec = build_sharded_blocked_executor(
                        asm, plan, self._mesh, self._axis, modes=modes_key
                    )
                elif self._schur_method == "auto":
                    # uniform lattice: strip-sharded assembly + replicated
                    # exact DCT λ solve (the forest planner rejects grids)
                    from .grid_sharded import (
                        build_sharded_grid_executor,
                        plan_sharded_grid,
                    )

                    gplan = plan_sharded_grid(asm, D, modes=modes_key)
                    if gplan is not None:
                        self._blocked_exec = build_sharded_grid_executor(
                            asm, gplan, self._mesh, self._axis,
                            modes=modes_key,
                        )
        if self._blocked_exec is None and self._schur_method == "blocked":
            # re-raise on EVERY solve — a forced 'blocked' must never
            # silently fall through to the general pipeline
            raise ValueError(
                "schur_method='blocked' requires a uniformly-K-ary "
                "forest with per-edge coefficients and a level width "
                "divisible by the device count"
            )
        if self._blocked_exec is not None:
            return self._solve_blocked(functions)

        # --- distributed λ elimination (multiplier axis sharded too)
        if self._dist_plan is None and self._schur_method in ("auto", "tree_dist"):
            B = net.num_multipliers
            forced = self._schur_method == "tree_dist"
            want = forced or (B > _DIST_LAMBDA_THRESHOLD and D > 1)
            if want and B > 0:
                from ..solver import _cached_tree_plan

                tree_plan = _cached_tree_plan(asm)
                from .distributed_tree import plan_distributed_tree

                self._dist_plan = plan_distributed_tree(asm, tree_plan, D)
                if self._dist_plan is None and self._schur_method == "tree_dist":
                    raise ValueError(
                        "tree_dist requires a forest bifurcation graph with "
                        "a bounded top tree (chain-like or cyclic networks "
                        "fall back to schur_method='auto')"
                    )
        if self._dist_plan is not None:
            return self._solve_distributed(functions)

        n_pad = (-E) % D
        ed = _pad_edge_data(self._edge_data, n_pad, n_cells=net.N)
        ed = jax.device_put(ed, self._edge_sharding(ed))

        if self._pipeline is None:
            tree_plan = None
            level_plan = None
            if self._schur_method in ("auto", "tree") and net.num_multipliers > 0:
                from ..solver import _cached_tree_plan

                tree_plan = _cached_tree_plan(asm)
                if tree_plan is not None and tree_plan.core_size > 512:
                    # large unstructured cycle core: sparse elimination
                    # (replicated after the one w_pairs psum) instead of
                    # the O(core³) dense factor; plan shared with any
                    # serial executor over the same assembler
                    tree_plan = _cached_tree_plan(asm, attach=True)
                level_plan = _plan_level_elimination(asm, tree_plan)
            self._tree_plan = tree_plan
            self._pipeline = _sharded_schur_pipeline(
                self._mesh,
                self._axis,
                net.num_multipliers,
                asm.flux_degree,
                net.N,
                self._schur_method if self._schur_method != "tree_dist" else "auto",
                tree_plan=tree_plan,
                level_plan=level_plan,
                ed_template=ed,
            )
        edge_pair = np.full(E + n_pad, -1, dtype=np.int32)
        if self._tree_plan is not None:
            edge_pair[:E] = self._tree_plan.edge_pair
        edge_pair_dev = jax.device_put(
            jnp.asarray(edge_pair), NamedSharding(self._mesh, P(self._axis))
        )
        out = self._pipeline(ed, edge_pair_dev)
        self.device_io = ((ed, edge_pair_dev), out)
        q_edge, p_cells, lam = out
        q_edge = _to_host(q_edge)[:E]
        p_cells = _to_host(p_cells)[:E]
        lam = _to_host(lam)
        self._info = SolveInfo("schur_sharded", 0, 0.0, True)
        return self._scatter_solution(q_edge, p_cells, lam, functions)

    def _solve_blocked(
        self, functions: list[NetworkFunction] | None
    ) -> list[NetworkFunction]:
        """Blocked-sibling sharded path: per-device slice/concat programs,
        one psum of the tiny top-tree system per solve."""
        asm = self._assembler
        ex = self._blocked_exec
        plan = ex.plan
        # coefficients captured at assemble() time (reference semantics)
        coeff = getattr(self, "_coeff_args", None)
        if coeff is None:
            coeff = asm.schur_arguments(device=False)
        args = ex.prepare_args(*coeff)
        out = ex(*args)
        self.device_io = (args, out)
        # Dispatch on the executor's declared identity, not tuple arity
        # (arity alone would silently mis-bind positions if a variant
        # ever adds/removes an output).
        is_grid = getattr(ex, "method_name", "") == "schur_sharded_grid"
        if is_grid != (len(out) == 7):
            raise RuntimeError(
                f"sharded executor output arity {len(out)} contradicts "
                f"method_name={getattr(ex, 'method_name', '?')!r}"
            )
        if is_grid:
            # grid executor: surfaces the λ-system residual.  ABSOLUTE,
            # matching every serial path's SolveInfo.residual convention
            # (callers compare against atol-style floors and serial runs).
            q_T, p_T, lam_loc, lam_T, res, rhs_n, finite = out
            residual = float(res)
        else:
            # blocked forest executor: exact elimination, no residual
            q_T, p_T, lam_loc, lam_T, _rhs, finite = out
            residual = 0.0
        q = _to_host(q_T).T  # (D*E_loc, k*N+1)
        p = _to_host(p_T).T  # (D*E_loc, N)
        q_edge = q[plan.edge_flat]  # public edge order
        p_cells = p[plan.edge_flat]
        lam_flat = np.concatenate([_to_host(lam_loc), _to_host(lam_T)])
        lam = lam_flat[plan.lam_src]
        ok = bool(np.asarray(finite))
        method = getattr(ex, "method_name", "schur_sharded_blocked")
        self._info = SolveInfo(method, 0, residual, ok)
        if not ok:
            raise RuntimeError(
                "Solver did not converge: sharded blocked solve produced "
                "non-finite values"
            )
        return self._scatter_solution(q_edge, p_cells, lam, functions)

    def _solve_distributed(
        self, functions: list[NetworkFunction] | None
    ) -> list[NetworkFunction]:
        """Distributed-λ path: edges re-partitioned to follow the subtree
        node partition; per-device local elimination + psum'd top system."""
        from .distributed_tree import plan_rows

        asm = self._assembler
        net = asm.network
        plan = self._dist_plan
        E = net.num_edges
        k, N = asm.flux_degree, net.N

        # one inert pad edge at index E backs every padding slot
        ed = _pad_edge_data(self._edge_data, 1, n_cells=N)
        perm = plan.edge_perm.reshape(-1)

        def take(a):
            return None if a is None else jnp.asarray(np.asarray(a)[perm])

        interior = ed.interior
        if interior and interior[0].ndim == 3:
            # per-cell recovery tensors follow the edge permutation; the
            # fixed 2-D scalar-layout matrix is shared and needs none
            (Minv_IE,) = interior
            per_edge = np.asarray(Minv_IE).reshape(E + 1, N, *Minv_IE.shape[1:])
            interior = (jnp.asarray(per_edge[perm].reshape(perm.size * N, *Minv_IE.shape[1:])),)
        ed = _EdgeData(
            mt=take(ed.mt),
            cumF=take(ed.cumF),
            W=take(ed.W),
            g=take(ed.g),
            start_bif=jnp.asarray(plan.e_start_loc.reshape(-1)),
            end_bif=jnp.asarray(plan.e_end_loc.reshape(-1)),
            start_pbc=take(ed.start_pbc),
            end_pbc=take(ed.end_pbc),
            interior=interior,
            rh=take(ed.rh),
            ua=take(ed.ua),
            uF=take(ed.uF),
        )
        sharding = NamedSharding(self._mesh, P(self._axis))
        ed = jax.device_put(ed, self._edge_sharding(ed))
        rows = jax.device_put(plan_rows(plan), {f: sharding for f in plan_rows(plan)})

        if self._pipeline is None:
            self._pipeline = _distributed_tree_pipeline(
                self._mesh, self._axis, plan, k, N, ed_template=ed
            )
        out = self._pipeline(ed, rows)
        self.device_io = ((ed, rows), out)
        q_edge, p_cells, lam_loc, lam_T = out
        inv = plan.edge_inv
        q_edge = _to_host(q_edge)[inv]
        p_cells = _to_host(p_cells)[inv]
        lam_flat = np.concatenate([_to_host(lam_loc), _to_host(lam_T)])
        lam = lam_flat[plan.lam_src]
        self._info = SolveInfo("schur_sharded_dist", 0, 0.0, True)
        return self._scatter_solution(q_edge, p_cells, lam, functions)

    def _scatter_solution(
        self,
        q_edge: np.ndarray,
        p_cells: np.ndarray,
        lam: np.ndarray,
        functions: list[NetworkFunction] | None,
    ) -> list[NetworkFunction]:
        asm = self._assembler
        net = asm.network
        if functions is None:
            functions = [
                NetworkFunction(sp, name=f"flux_color_{i}")
                for i, sp in enumerate(asm.flux_spaces)
            ]
            functions.append(NetworkFunction(asm.pressure_space, name="pressure"))
            functions.append(NetworkFunction(asm.lm_space, name="global_flux"))
        x = _scatter_blocks_to_x(asm, q_edge, p_cells, lam)
        offs = asm.block_offsets
        for i, fn in enumerate(functions):
            fn.values[...] = x[offs[i] : offs[i + 1]]
        return functions

    def _edge_sharding(self, ed: _EdgeData):
        """NamedSharding pytree matching the shard_map input specs."""
        s = NamedSharding(self._mesh, P(self._axis))
        return _edge_specs(ed, s, NamedSharding(self._mesh, P()))


def shard_solve(
    assembler: _assembly.HydraulicNetworkAssembler,
    devices=None,
    functions: list[NetworkFunction] | None = None,
) -> list[NetworkFunction]:
    """One-shot sharded assemble+solve convenience wrapper."""
    solver = ShardedNetworkSolver(assembler, devices=devices)
    solver.assemble()
    return solver.solve(functions)
