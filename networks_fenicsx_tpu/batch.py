"""Batched scenario solves (parameter sweeps) in one device dispatch.

A production capability with no counterpart in the PETSc/MUMPS reference:
because the fused assemble→condense→solve executor is a pure function,
``jax.vmap`` maps it over stacked coefficient scenarios — hundreds of
resistance/source/boundary-condition variants solved in a single XLA
program launch (one systolic sweep instead of a host loop of factorise+
solve calls).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .assembly import HydraulicNetworkAssembler
from .solver import build_schur_executor
from .utils.config import SolverOptions

__all__ = ["SweepResult", "solve_sweep"]


class SweepResult:
    """Solutions of a coefficient sweep.

    Device-side the solutions live as j-major blocks (``q_T`` (S, k·N+1, E),
    ``p_T`` (S, N, E), ``lam`` (S, B) — see ``_solution_blocks_T``); the
    flat ``(S, num_dofs)`` global layout ``[q_0..q_{M-1}, p, λ]`` is
    materialised lazily on the host at first ``.x`` access (the color-sort
    permutation and relayout would serialize as device gathers)."""

    def __init__(
        self,
        assembler: HydraulicNetworkAssembler,
        x: jnp.ndarray | None = None,
        blocks: tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
        edge_order: np.ndarray | None = None,
        bif_order: np.ndarray | None = None,
        device_io: tuple | None = None,
    ):
        self.assembler = assembler
        self._x = x
        self.blocks = blocks
        self._edge_order = edge_order
        self._bif_order = bif_order
        # (inputs, outputs) device arrays of a sharded sweep's program
        self.device_io = device_io
        if x is None and blocks is None:
            raise ValueError("provide x or blocks")

    @property
    def x(self) -> np.ndarray | jnp.ndarray:
        if self._x is None:
            from .solver import _flatten_blocks_host

            q_T, p_T, lam = self.blocks
            self._x = _flatten_blocks_host(
                q_T,
                p_T,
                lam,
                self.assembler.network.edge_color,
                edge_order=self._edge_order,
                bif_order=self._bif_order,
            )
        return self._x

    @property
    def num_scenarios(self) -> int:
        src = self._x if self._x is not None else self.blocks[0]
        return int(src.shape[0])

    def block(self, i: int) -> jnp.ndarray:
        """All scenarios of solution block ``i``: shape (S, block_size)."""
        offs = self.assembler.block_offsets
        return self.x[:, offs[i] : offs[i + 1]]

    def pressures(self) -> jnp.ndarray:
        return self.block(self.assembler.network.num_edge_colors)

    def multipliers(self) -> jnp.ndarray:
        return self.block(self.assembler.network.num_edge_colors + 1)

    def functions(self, scenario: int):
        """Materialise the reference-style function list for one scenario."""
        from .function import NetworkFunction

        asm = self.assembler
        offs = asm.block_offsets
        x = np.asarray(self.x[scenario])
        out = []
        names = [f"flux_color_{i}" for i in range(asm.network.num_edge_colors)]
        names += ["pressure", "global_flux"]
        for i, (sp, name) in enumerate(zip(asm.function_spaces, names)):
            out.append(NetworkFunction(sp, x[offs[i] : offs[i + 1]], name=name))
        return out


def solve_sweep(
    assembler: HydraulicNetworkAssembler,
    R: np.ndarray | jnp.ndarray | None = None,
    f: np.ndarray | jnp.ndarray | None = None,
    p_bc_node_values: np.ndarray | jnp.ndarray | None = None,
    options: SolverOptions | None = None,
    devices=None,
) -> SweepResult:
    """Solve a batch of coefficient scenarios in one vmapped dispatch.

    ``compute_forms`` must have been called once with representative
    coefficients — it fixes the coefficient *kinds* (scalar / per-edge /
    per-cell / per-quadrature) and the boundary-condition structure.  Each
    batch argument stacks scenarios on a leading axis over the compact
    representation of that kind:

    Args:
        assembler: Assembler with forms computed.
        R: Optional (S, ...) resistance batch — trailing shape must match
            ``assembler.schur_arguments()[0]`` (e.g. (S, E) for per-edge R,
            (S, 1) for scalar R).
        f: Optional (S, ...) source batch, analogous.
        p_bc_node_values: Optional (S, num_graph_nodes) boundary pressure
            values per graph node (only boundary-node entries are used).
        options: Solver options (schur path; default auto).
        devices: Optional device list — shards the SCENARIO axis over
            them (data-parallel serving: each device solves its chunk of
            the batch through the same vmapped executor; no cross-device
            communication).  Requires the batch size to be divisible by
            the device count.  Works for every topology, including the
            blocked forest and lattice DCT executors.

    Returns:
        :class:`SweepResult` with ``x`` of shape (S, num_dofs).
    """
    asm = assembler
    opts = options or SolverOptions()
    if asm.network.has_floating_component():
        raise RuntimeError("network has a component with no boundary node")

    sizes = []
    for arr in (R, f, p_bc_node_values):
        if arr is not None:
            sizes.append(int(np.shape(arr)[0]))
    if not sizes:
        raise ValueError("provide at least one batched coefficient")
    S = sizes[0]
    if any(s != S for s in sizes):
        raise ValueError(f"inconsistent batch sizes: {sizes}")

    mesh = asm.network

    in_axes = (
        0 if R is not None else None,
        0 if f is not None else None,
        0 if p_bc_node_values is not None else None,
        0 if p_bc_node_values is not None else None,
    )

    # Cache the traced+compiled batched program on the assembler: repeated
    # sweeps with the same structure dispatch the cached executable.
    # Sweeps default to the batched dense-Cholesky Schur solve for
    # small-to-medium bifurcation counts rather than batching the tree
    # rounds' scatters (a choice made on earlier hardware; ROADMAP
    # Queue 2 re-examines it for cyclic cores).
    B = mesh.num_multipliers
    if opts.schur_method == "auto" and 0 < B <= 4096:
        from .solver import lattice_solve_applicable

        # Uniform lattices take the exact DCT solve: it vmaps without a
        # per-scenario B×B Cholesky (and the grid-layout executor keeps
        # the per-scenario work gather-free).  Everything else falls back
        # to the batched dense-Cholesky Schur solve.  The probe is host
        # planning (O(E)) — cache it per coefficient-kind signature so
        # repeated sweeps skip it.
        probe_key = asm.coefficient_modes()
        cached = getattr(asm, "_lattice_probe", None)
        if cached is None or cached[0] != probe_key:
            cached = (probe_key, lattice_solve_applicable(asm))
            asm._lattice_probe = cached
        if cached[1]:
            opts = dataclasses.replace(opts, schur_method="dct")
        else:
            opts = dataclasses.replace(opts, schur_method="dense")
    # EVERY option field keys the cache — an f32 sweep followed by a
    # default-f64 sweep (or a level_scan/output_dtype change) must not
    # silently reuse the first compiled executor.
    key = (in_axes, dataclasses.astuple(opts), asm.coefficient_modes())
    cache = getattr(asm, "_sweep_cache", None)
    if cache is None:
        cache = asm._sweep_cache = {}
    entry = cache.get(key)
    if entry is None:
        # A batched f must flow through the executor's f argument — the
        # zero-source program variant would silently ignore it.
        executor = build_schur_executor(
            asm, opts, jit=False, elide_zero_f=(f is None),
            outputs="blocks", internal_layout=True,
        )

        def one(Ra, fa, spa, epa):
            q_T, p_T, lam, *_ = executor(Ra, fa, spa, epa)
            return q_T, p_T, lam

        entry = (jax.jit(jax.vmap(one, in_axes=in_axes)), executor)
        cache[key] = entry
    batched, executor = entry
    edge_order = getattr(executor, "edge_order", None)
    bif_order = getattr(executor, "bif_order", None)
    prepare = getattr(executor, "prepare_args", None)

    base_R, base_f, base_sp, base_ep = asm.schur_arguments(device=prepare is None)
    # Kind check: a batch whose trailing shape disagrees with the compute_forms
    # representative silently solves the wrong problem (e.g. an (S, E)
    # per-edge batch against scalar-kind forms feeds element [0] per
    # scenario) — fail loudly instead.
    for name, batch, base in (("R", R, base_R), ("f", f, base_f)):
        if batch is not None and tuple(np.shape(batch)[1:]) != tuple(
            np.shape(base)
        ):
            raise ValueError(
                f"{name} batch trailing shape {tuple(np.shape(batch)[1:])} does "
                f"not match the coefficient kind fixed by compute_forms "
                f"(expected {tuple(np.shape(base))}); recompute forms with a "
                f"representative {name} of the batched kind"
            )
    if prepare is not None:
        base_R, base_f, base_sp, base_ep = prepare(base_R, base_f, base_sp, base_ep)

    def batch_edge_kind(arr, mode):
        # Only touch the host when a permutation is actually needed —
        # np.asarray on a device-resident batch would force a device→host
        # round trip per sweep.
        if edge_order is not None and mode == "cell":
            # (S, C) public cell order -> (S, N, E) j-major internal blocks
            # (the batched mirror of _BlockedExecutor._permute)
            a = np.asarray(arr)
            E = edge_order.shape[0]
            return jnp.asarray(
                np.ascontiguousarray(
                    a.reshape(a.shape[0], E, -1)[:, edge_order].swapaxes(1, 2)
                )
            )
        if edge_order is not None and mode != "scalar":
            return jnp.asarray(np.asarray(arr)[:, edge_order])
        return jnp.asarray(arr)

    if p_bc_node_values is not None:
        # boundary-pressure expansion in the executor's edge order
        pbv = jnp.asarray(p_bc_node_values)
        edges = mesh.edges if edge_order is None else mesh.edges[edge_order]
        sb = np.asarray(asm._edge_start_bif)
        eb = np.asarray(asm._edge_end_bif)
        if edge_order is not None:
            sb, eb = sb[edge_order], eb[edge_order]
        sp_batch = jnp.where(jnp.asarray(sb < 0)[None, :], pbv[:, edges[:, 0]], 0.0)
        ep_batch = jnp.where(jnp.asarray(eb < 0)[None, :], pbv[:, edges[:, 1]], 0.0)
    else:
        sp_batch = None
        ep_batch = None

    R_mode, f_mode, _ = asm.coefficient_modes()
    call_args = (
        batch_edge_kind(R, R_mode) if R is not None else base_R,
        batch_edge_kind(f, f_mode) if f is not None else base_f,
        sp_batch if sp_batch is not None else base_sp,
        ep_batch if ep_batch is not None else base_ep,
    )
    if devices is not None and len(devices) > 1:
        # Scenario-axis data parallelism: shard every batched arg's
        # leading axis over the device mesh and let XLA partition the
        # vmapped program (pure per-scenario work — zero collectives).
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

        D = len(devices)
        if S % D != 0:
            raise ValueError(
                f"batch size {S} not divisible by device count {D}"
            )
        smesh = Mesh(np.asarray(devices), ("scen",))
        rep_sh = NamedSharding(smesh, Pspec())

        def place(arg, ax):
            if ax is None:
                return jax.device_put(arg, rep_sh)
            spec = Pspec(*(["scen"] + [None] * (np.ndim(arg) - 1)))
            return jax.device_put(arg, NamedSharding(smesh, spec))

        call_args = tuple(
            place(a, ax) for a, ax in zip(call_args, in_axes)
        )
    blocks = batched(*call_args)
    return SweepResult(
        asm, blocks=blocks, edge_order=edge_order, bif_order=bif_order
    )
