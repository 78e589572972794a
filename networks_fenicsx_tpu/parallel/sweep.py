"""Sharded parameter sweeps: scenarios × edges over a 2D device mesh.

Production-scale serving composition: the scenario axis is data-parallel
(each batch group solves independent coefficient variants) while within a
group the edge axis is model-parallel exactly like
:class:`~networks_fenicsx_tpu.parallel.sharding.ShardedNetworkSolver` —
per-edge condensation is local, the (small) per-scenario Schur systems are
reduced with one ``psum`` over the edge axis, factorised replicated, and
back-substituted locally.  ``vmap`` inside ``shard_map`` batches the local
scenario chunk, so the whole sweep is one XLA program over the full mesh.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import assembly as _assembly
from ..ops.scaled_cholesky import scaled_cholesky_factor, scaled_cholesky_solve
from ..batch import SweepResult

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

__all__ = ["sharded_sweep"]


def sharded_sweep(
    assembler: _assembly.HydraulicNetworkAssembler,
    R: np.ndarray,
    devices=None,
    mesh_shape: tuple[int, int] | None = None,
) -> SweepResult:
    """Solve a batch of per-edge resistance scenarios over a 2D device mesh.

    Args:
        assembler: Assembler with forms computed (DG0 pressure, flux degree
            1; per-edge resistance kind).
        R: (S, E) per-edge resistance scenarios.
        devices: Device list (default: all).
        mesh_shape: (batch_devices, edge_devices); default puts all devices
            on the scenario axis.

    Returns:
        :class:`SweepResult` with ``x`` of shape (S, num_dofs).
    """
    asm = assembler
    net = asm.network
    if asm.pressure_degree != 0:
        raise ValueError("sharded_sweep requires DG0 pressure")
    modes = asm.coefficient_modes()
    if modes[0] not in ("edge", "scalar"):
        raise ValueError(
            "compute_forms must have been called with per-edge R (or "
            "scalar R on a uniform lattice)"
        )
    if net.has_floating_component():
        raise RuntimeError("network has a component with no boundary node")

    devs = np.asarray(devices if devices is not None else jax.devices())
    if mesh_shape is None:
        mesh_shape = (devs.size, 1)
    Db, De = mesh_shape
    mesh2d = Mesh(devs.reshape(Db, De), axis_names=("batch", "edges"))

    if modes[0] == "scalar":
        # Scalar-R scenarios: the uniform-lattice (separable-DCT) envelope
        # — scenario axis data-parallel, strips local (the executor's
        # psums batch over the edge axis).  Per-edge R would disqualify
        # the DCT exactly as in the serial executor.
        from .grid_sharded import plan_sharded_grid, sharded_grid_sweep

        gplan = plan_sharded_grid(asm, De, modes=modes)
        if gplan is None:
            raise ValueError(
                "scalar-R sharded sweeps require a uniform rectangular "
                "lattice (make_grid family); other topologies take "
                "per-edge R through the forest/general paths"
            )
        x, io = sharded_grid_sweep(asm, gplan, np.asarray(R), mesh2d)
        return SweepResult(asm, jnp.asarray(x), device_io=io)

    # Blocked fast path (round 3): K-ary forests run the blocked
    # elimination vmapped over the scenario chunk — no dense per-scenario
    # Cholesky (the legacy path's O(B²) memory made big-network sweeps
    # infeasible), and nonzero fixed sources are supported.
    if modes[1] in ("scalar", "edge"):
        from .blocked_sharded import plan_sharded_blocked, sharded_blocked_sweep

        plan = plan_sharded_blocked(asm, De)
        if plan is not None:
            x, io = sharded_blocked_sweep(asm, plan, np.asarray(R), mesh2d)
            return SweepResult(asm, jnp.asarray(x), device_io=io)

    if asm.flux_degree != 1:
        # the inline general path below hard-codes the P1 closed forms;
        # degree >= 2 sweeps ride the blocked path (any K-ary forest)
        raise ValueError(
            "sharded_sweep at flux degree >= 2 requires a blocked-eligible "
            "topology (uniformly-K-ary forest with per-edge coefficients)"
        )
    if not modes[2]:
        raise ValueError(
            "sharded_sweep's general path assumes a zero source (f=0); "
            "forms were computed with a nonzero f — use solve_sweep for "
            "source sweeps (or a blocked-eligible topology)"
        )

    R = np.asarray(R, dtype=np.float64)
    S, E = R.shape
    assert E == net.num_edges
    B = net.num_multipliers
    N = net.N

    # pad scenario and edge axes to the mesh shape
    S_pad = (-S) % Db
    E_pad = (-E) % De
    R_full = np.ones((S + S_pad, E + E_pad))
    R_full[:S, :E] = R

    # static per-edge host data (padded edges are inert: no bifurcations,
    # zero boundary pressure, unit length)
    def pad_edge(arr, fill):
        return np.concatenate([arr, np.full(E_pad, fill, arr.dtype)])

    h_edge = pad_edge(net.edge_length / N, 1.0)  # uniform h per edge (N cells)
    s_bif = pad_edge(asm._edge_start_bif, -1)
    t_bif = pad_edge(asm._edge_end_bif, -1)
    s_pbc = pad_edge(asm._edge_start_pbc, 0.0)
    t_pbc = pad_edge(asm._edge_end_pbc, 0.0)

    sb = jnp.asarray(s_bif)
    tb = jnp.asarray(t_bif)

    def local(R_loc, h_loc, sb_loc, tb_loc, sp_loc, ep_loc):
        s_is_bif = sb_loc >= 0
        t_is_bif = tb_loc >= 0
        s_idx = jnp.where(s_is_bif, sb_loc, 0)
        t_idx = jnp.where(t_is_bif, tb_loc, 0)

        def one(R_e):
            # P1 scalar layout, f = 0: W = R*h*N per edge, g = 0
            W = R_e * h_loc * N
            w = 1.0 / W
            const = (-sp_loc * (~s_is_bif) + ep_loc * (~t_is_bif)) / W

            rhs = jnp.zeros(B).at[t_idx].add(jnp.where(t_is_bif, const, 0.0))
            rhs = rhs.at[s_idx].add(jnp.where(s_is_bif, -const, 0.0))
            rhs = jax.lax.psum(rhs, "edges")
            L = jnp.zeros((B, B))
            L = L.at[t_idx, t_idx].add(jnp.where(t_is_bif, w, 0.0))
            L = L.at[s_idx, s_idx].add(jnp.where(s_is_bif, w, 0.0))
            both = s_is_bif & t_is_bif
            off_w = jnp.where(both, w, 0.0)
            L = L.at[s_idx, t_idx].add(-off_w)
            L = L.at[t_idx, s_idx].add(-off_w)
            L = jax.lax.psum(L, "edges")

            # shared Jacobi-scaled Cholesky with the singularity pivot
            # gate (NaN propagates to the caller's finiteness guard)
            lam = scaled_cholesky_solve(scaled_cholesky_factor(L), rhs)

            # local back-substitution (P1, f=0: flux constant per edge)
            lam_pad = jnp.concatenate([lam, jnp.zeros(1)])
            r0 = jnp.where(s_is_bif, lam_pad[sb_loc], -sp_loc)
            rN = jnp.where(t_is_bif, -lam_pad[tb_loc], ep_loc)
            q0 = (r0 + rN) / W
            q_chain = jnp.repeat(q0[:, None], N + 1, axis=1)
            # p_j = r0 − cumsum(m_nodes): for constant q the chain mass rows
            # are a·q/2 at the first node and a·q at interior nodes.
            a = R_e * h_loc
            p_cells = r0[:, None] - (
                (a * q0 / 2.0)[:, None] + (a * q0)[:, None] * jnp.arange(N)[None, :]
            )
            return q_chain, p_cells, lam

        return jax.vmap(one)(R_loc)

    spec_R = P("batch", "edges")
    spec_e = P("edges")
    out_specs = (P("batch", "edges"), P("batch", "edges"), P("batch"))
    fn = shard_map(
        local,
        mesh=mesh2d,
        in_specs=(spec_R, spec_e, spec_e, spec_e, spec_e, spec_e),
        out_specs=out_specs,
    )
    jfn = jax.jit(fn)

    put = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh2d, spec))  # noqa: E731
    ins = (
        put(R_full, spec_R),
        put(h_edge, spec_e),
        put(s_bif, spec_e),
        put(t_bif, spec_e),
        put(s_pbc, spec_e),
        put(t_pbc, spec_e),
    )
    outs = jfn(*ins)
    q_chain, p_cells, lam = outs
    q_chain = np.asarray(q_chain)[:S, :E]
    p_cells = np.asarray(p_cells)[:S, :E]
    lam = np.asarray(lam)[:S]

    # scatter into global layout (flux placement via _edge_flux_base —
    # no explicit color sort needed)
    from .sharding import _scatter_blocks_to_x

    x = _scatter_blocks_to_x(asm, q_chain, p_cells, lam)
    return SweepResult(asm, jnp.asarray(x), device_io=(ins, outs))
