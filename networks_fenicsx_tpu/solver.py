"""Solvers for the hydraulic network saddle-point system.

JAX replacement for the reference's PETSc KSP + MUMPS direct solve
(``src/networks_fenicsx/solver.py:16-143``; default options preonly+LU+MUMPS,
``solver.py:58-65``).  Methods:

* ``"schur"`` (default for DG0 pressure) — exact static condensation that
  exploits the network structure: with discontinuous pressure the system
  decouples into independent per-edge chains tied together ONLY by the
  bifurcation multipliers λ.  Eliminating flux and pressure edge-by-edge
  (closed-form cumulative sums — no LU at all) reduces the whole
  saddle-point system to an SPD weighted graph Laplacian on the
  bifurcations.  That Laplacian is solved by ``schur_method``:
  ``"tree"`` (auto for forests / small cycle cores) — scatter-free
  level-ordered elimination, exact and O(B); ``"dense"`` — Jacobi-scaled
  Cholesky with a singularity pivot gate; ``"cg"`` — matrix-free
  Jacobi-preconditioned CG for
  huge cyclic cores.  All per-edge work is batched over the edge axis —
  embarrassingly parallel, shardable across devices.
* ``"schur_p"`` (default for continuous pressure) — per-edge flux
  elimination (batched f64 Cholesky of the edge mass bands) + CG on the
  SPD reduced operator over (p, −λ).
* ``"dense"`` — assembled dense solve (float64 LU).
* ``"minres"`` — on-device MINRES on the symmetrized block system with a
  block-diagonal preconditioner (generic saddle-point fallback).
* ``"host_lu"`` — SciPy sparse LU on the host: the direct-solver
  verification fallback playing MUMPS's role.

Derivation of the Schur path (flux degree k, DG0 pressure). Interior cell
dofs see no pressure coupling (``∫ p v' = 0`` for cell-interior v with
cellwise-constant p), so each cell's mass block condenses to an effective
2x2 endpoint matrix M̃.  Along an edge with chain nodes ``q_0..q_N``,
cells ``p_0..p_{N-1}`` and endpoint data ``r_0``/``r_N`` (multiplier λ at a
bifurcation, ∓p_bc at a boundary — reference sign conventions
``assembly.py:258-277``):

    continuity:  q_{j+1} − q_j = F_j          (F_j = ∫_cell f)
    momentum:    m_0 + p_0 = r_0;   m_i + p_i − p_{i-1} = 0;
                 m_N − p_{N-1} = r_N           (m = condensed chain mass · q)

Summing the momentum rows eliminates p:  1ᵀM(q_0·1 + cumsum F) = r_0 + r_N,
hence  q_0 = (r_0 + r_N − g_e) / W_e  with  W_e = 1ᵀM1 (edge resistance)
and  g_e = 1ᵀM·cumsumF.  Substituting into the bifurcation constraints
Σq_in − Σq_out = 0 yields  L λ = rhs  with L the bifurcation-graph
Laplacian weighted by 1/W_e — SPD whenever every network component reaches
a boundary.  Pressure back-substitutes as  p_i = r_0 − cumsum(m)_i.
"""

from __future__ import annotations

import collections
import functools
import os
import typing

import numpy as np

import jax
import jax.numpy as jnp

from . import assembly as _assembly
from .function import NetworkFunction
from .ops import elements, krylov
from .ops.scaled_cholesky import scaled_cholesky_factor, scaled_cholesky_solve
from .utils.config import SolverOptions
from .utils.timing import timed

__all__ = ["Solver", "SolveInfo"]

# Full-f32 matmuls: on GPUs XLA's default f32 precision may take TF32
# passes (10-bit mantissa), which the float32 serving mode cannot afford.
_HI = jax.lax.Precision.HIGHEST


class SolveInfo(typing.NamedTuple):
    method: str
    iterations: int
    residual: float
    converged: bool


def _symmetrize_signs(offsets: np.ndarray, M: int, n: int) -> np.ndarray:
    """Diagonal ±1 making the block system symmetric: the reference's
    pressure rows carry +div while the flux rows carry −divᵀ
    (``assembly.py:254-255``); negating the pressure rows restores symmetry."""
    s = np.ones(n)
    s[offsets[M] : offsets[M + 1]] = -1.0
    return s


class Solver:
    """Solver for the network problem (reference API: ``solver.py:16-143``).

    Args:
        assembler: The hydraulic network assembler.
        petsc_options_prefix: Accepted for reference API parity; unused.
        petsc_options: Reference-style options dict; recognised keys are
            mapped onto :class:`SolverOptions` (e.g. ``ksp_monitor``,
            ``ksp_error_if_not_converged``), solver-choice keys are ignored
            because method selection is native here.
        kind: Matrix layout for the generic paths ("bcoo"/"dense"/"nest");
            the schur path never materialises the global matrix.
        options: Native options (:class:`SolverOptions` or dict).
    """

    def __init__(
        self,
        assembler: _assembly.HydraulicNetworkAssembler,
        petsc_options_prefix: str = "NetworkSolver_",
        petsc_options: dict | None = None,
        kind: str | None = None,
        options: SolverOptions | dict | None = None,
    ):
        del petsc_options_prefix
        self._assembler = assembler
        if isinstance(options, dict):
            options = SolverOptions.from_dict(options)
        self._options = options or SolverOptions()
        if petsc_options:
            if "ksp_monitor" in petsc_options:
                self._options.monitor = True
            if "ksp_error_if_not_converged" in petsc_options:
                self._options.error_if_not_converged = bool(
                    petsc_options["ksp_error_if_not_converged"]
                )
        self._kind = kind
        self._A = None
        self._b = None
        self._edge_data = None
        self._x = None
        self._info: SolveInfo | None = None
        self._executor = None  # cached jitted schur pipeline
        self._executor_key = None
        self._factorization = None  # (fac, state, R_digest) from factorize()

    # ------------------------------------------------------------ properties
    @property
    def assembler(self) -> _assembly.HydraulicNetworkAssembler:
        return self._assembler

    @property
    def A(self):
        """Assembled system matrix (None for the pure-schur path unless a
        generic assemble was requested)."""
        return self._A

    @property
    def b(self):
        return self._b

    @property
    def info(self) -> SolveInfo | None:
        """Diagnostics of the last solve."""
        return self._info

    def set_executor(self, executor) -> None:
        """Install a pre-built (pre-compiled) fused schur executor, keyed to
        the assembler's current coefficient kinds."""
        self._executor = executor
        self._executor_key = self._assembler.coefficient_modes()

    def factorize(self) -> None:
        """Cache a coefficient-side factorization for rhs-only re-solves.

        The reference's KSP retains the MUMPS factorization across solves
        (reference ``solver.py:58-65``); after this call, subsequent
        :meth:`solve` calls whose resistance data is unchanged (only
        ``f``/``p_bc`` differ between ``compute_forms`` calls) run the
        rhs-only half of the elimination against the cached factor.  A
        changed R (or a topology outside the blocked/lattice envelopes)
        silently falls back to the fused path.

        Convergence contract on the factorized path: the solve is the
        same exact direct elimination as the fused executor and is gated
        on FINITENESS (the singularity analog of
        ``ksp_error_if_not_converged``); it does not recompute the
        fused path's residual-vs-tolerance floor per rhs — the factor was
        validated when it was built, and an extra residual matvec per
        rhs-only solve would defeat the serving speedup.  Callers needing
        a per-solve residual bound should run the fused :meth:`solve`
        (drop the factor) or check ``SolveInfo.residual`` where the
        executor surfaces one (lattice path).
        """
        import hashlib

        if self._method() != "schur":
            raise ValueError("factorize() applies to the schur method only")
        asm = self._assembler
        R_data = asm.schur_arguments(device=False)[0]
        digest = hashlib.sha1(np.ascontiguousarray(R_data).tobytes()).digest()
        fac = None
        for cls in (BlockedFactorization, GridFactorization, TreeFactorization):
            try:
                fac = cls(asm, self._options)
                break
            except ValueError:
                continue
        if fac is None:
            raise ValueError(
                "factorize() requires scalar/per-edge/per-cell coefficients "
                "and a topology the direct paths serve (uniformly-K-ary "
                "forest, uniform lattice, or the general peel-then-core "
                "plan — quad-mode callables and fill-budget-breaching "
                "cores stay on the fused path)"
            )
        self._factorization = (
            fac, fac.factor(R_data), digest, asm.coefficient_modes(),
            getattr(asm, "_R_generation", 0),
        )

    def _method(self) -> str:
        m = self._options.method
        if m != "auto":
            return m
        if self._assembler.pressure_degree == 0:
            return "schur"
        return "schur_p"

    # -------------------------------------------------------------- assemble
    def assemble(self, lhs: bool = True, rhs: bool = True) -> None:
        """Assemble the system (reference ``solver.py:90-101``).

        For the schur method this prepares the per-edge condensed data; for
        the generic methods it assembles the global matrix/vector.
        """
        method = self._method()
        if method == "schur":
            # Nothing to materialise: coefficient data from compute_forms()
            # feeds the fused condense→solve executable directly.
            self._assembler._require_forms()
        if method != "schur" or self._kind is not None:
            kind = self._kind or ("dense" if method == "dense" else "bcoo")
            A, b = self._assembler.assemble(
                assemble_lhs=lhs, assemble_rhs=rhs, kind=kind
            )
            self._A, self._b = A, b

    # ----------------------------------------------------------------- solve
    @timed("nxfx:Solver:solve", block=True)
    def solve(self, functions: list[NetworkFunction] | None = None) -> list[NetworkFunction]:
        """Solve and scatter into solution functions.

        Returns the reference's function list contract (``solver.py:120-125``):
        ``[flux_color_0, ..., flux_color_{M-1}, pressure, global_flux]``
        where ``global_flux`` holds the multiplier values.
        """
        method = self._method()
        if method == "schur" and self._factorization is not None:
            # factor-reuse fast path (see factorize()): engage only while
            # the resistance data is byte-identical to the captured factor.
            # The per-solve staleness check is O(1): the assembler bumps an
            # R-generation counter unless compute_forms() received the SAME
            # IMMUTABLE R input (read-only ndarray / jax array / equal
            # scalar — a writeable ndarray can be mutated in place, so its
            # identity proves nothing); the O(E) byte hash runs once per
            # generation bump, not per solve (the rhs-only serving loop —
            # the path the factorization exists to make cheap — never pays it).
            fac, state, digest, modes, gen = self._factorization
            asm = self._assembler
            args = asm.schur_arguments(device=False)
            gen_now = getattr(asm, "_R_generation", 0)
            fresh = gen_now == gen
            if not fresh:
                # inconclusive (new R input object): compare bytes once and
                # re-arm the generation on a match
                import hashlib

                now = hashlib.sha1(
                    np.ascontiguousarray(args[0]).tobytes()
                ).digest()
                if now == digest:
                    fresh = True
                    self._factorization = (fac, state, digest, modes, gen_now)
            # the captured factor is valid only while BOTH the resistance
            # bytes and the coefficient KINDS (R_mode, f_mode) match — a
            # kind change would feed the wrong layout into the cached
            # solve program.  The f_zero flag is deliberately ignored:
            # the factorization solve paths always process f at runtime
            # (no zero-source elision), so switching f between zero and
            # nonzero is exactly the rhs-only serving contract, not a
            # staleness event.
            if fresh and modes[:2] == asm.coefficient_modes()[:2]:
                out = fac.solve(state, args[1], args[2], args[3])
                x = fac.solution_vector(out)
                finite = bool(np.asarray(out[-1]))
                # explicit contract, not tuple arity: only the grid
                # factorization surfaces a λ residual (out[-3])
                residual = (
                    float(out[-3]) if fac.solve_has_residual else 0.0
                )
                info = SolveInfo("schur_factorized", 0, residual, finite)
                self._x, self._info = jnp.asarray(x), info
                if self._options.monitor:
                    print(
                        f"[nxfx] method={info.method} iters=0 "
                        f"residual={residual:.3e} converged={finite}"
                    )
                if self._options.error_if_not_converged and not finite:
                    raise RuntimeError(
                        "Solver did not converge: factorized solve produced "
                        "non-finite values"
                    )
                return self._scatter_functions(functions, np.asarray(x))
            # stale factor (R changed): drop it and fall through
            self._factorization = None
        if method == "schur":
            # Executor argument shapes depend on the coefficient kinds; a
            # compute_forms() call with different kinds invalidates the cache.
            key = self._assembler.coefficient_modes()
            if self._executor is None or self._executor_key != key:
                self._executor = build_schur_executor(
                    self._assembler,
                    self._options,
                    outputs="blocks",
                    internal_layout=True,
                )
                self._executor_key = key
            x, info = _schur_solve(self._assembler, self._options, self._executor)
        elif method == "schur_p":
            if self._assembler.network.has_floating_component():
                raise RuntimeError(
                    "Solver did not converge: network has a component with "
                    "no boundary node — the system is singular"
                )
            x, info = _continuous_pressure_solve(self._assembler, self._options)
        else:
            if self._A is None or self._b is None:
                self.assemble()
            x, info = _generic_solve(self._A, self._b, self._assembler, method, self._options)
        self._x = x
        self._info = info
        if self._options.monitor:
            print(
                f"[nxfx] method={info.method} iters={info.iterations} "
                f"residual={info.residual:.3e} converged={info.converged}"
            )
        if self._options.error_if_not_converged and not info.converged:
            raise RuntimeError(
                f"Solver did not converge: method={info.method}, "
                f"residual={info.residual:.3e}"
            )

        # Scatter into block functions (reference fem.petsc.assign, solver.py:134).
        return self._scatter_functions(functions, np.asarray(x))

    def _scatter_functions(
        self, functions: list[NetworkFunction] | None, x_np: np.ndarray
    ) -> list[NetworkFunction]:
        asm = self._assembler
        if functions is None:
            functions = [
                NetworkFunction(sp, name=f"flux_color_{i}")
                for i, sp in enumerate(asm.flux_spaces)
            ]
            functions.append(NetworkFunction(asm.pressure_space, name="pressure"))
            functions.append(NetworkFunction(asm.lm_space, name="global_flux"))
        offs = asm.block_offsets
        for i, fn in enumerate(functions):
            fn.values[...] = x_np[offs[i] : offs[i + 1]]
        return functions

    def solution_vector(self) -> jnp.ndarray | None:
        """The raw solution in global block layout."""
        return self._x


# ======================================================================
# Schur path: per-edge condensation + bifurcation Laplacian
# ======================================================================


class _EdgeData(typing.NamedTuple):
    """Per-edge condensed arrays, all edge-major; see module docstring.

    Two layouts: the general one stores per-cell 2x2 condensed endpoint
    matrices in ``mt``; for degree-1 flux with cellwise-constant resistance
    every cell matrix is ``a_c * M̂`` with the fixed P1 mass ``M̂``, so only
    the scalars ``a_c = R_c h_c`` are stored in ``rh`` (``mt`` is None) —
    4x less HBM traffic on the dominant path."""

    mt: jnp.ndarray | None  # (E, N, 2, 2) condensed cell endpoint mass
    cumF: jnp.ndarray  # (E, N+1) cumulative ∫f along chain nodes
    W: jnp.ndarray  # (E,) 1ᵀM1 — total edge resistance
    g: jnp.ndarray  # (E,) 1ᵀM·cumF
    start_bif: jnp.ndarray  # (E,) bifurcation index at source or -1
    end_bif: jnp.ndarray  # (E,)
    start_pbc: jnp.ndarray  # (E,) −p_bc contribution at source boundary
    end_pbc: jnp.ndarray  # (E,) +p_bc contribution at target boundary
    interior: tuple  # () or (Minv_IE (C,k-1,2),) interior recovery data
    rh: jnp.ndarray | None = None  # (E, N) cell scalars for the P1 layout
    # uniform-coefficient layout (P1 + per-edge-constant R and f): all
    # per-cell arrays collapse to closed forms of these two (E,) vectors
    ua: jnp.ndarray | None = None  # a_e = R_e h_e
    uF: jnp.ndarray | None = None  # F_e = f_e h_e (per-cell source integral)


def _make_edge_data_uniform(
    asm: _assembly.HydraulicNetworkAssembler,
    R_data: jnp.ndarray,
    f_data: jnp.ndarray,
    start_pbc: jnp.ndarray,
    end_pbc: jnp.ndarray,
    R_mode: str,
    f_mode: str,
) -> _EdgeData:
    """Uniform-coefficient layout: P1 flux with R and f constant per edge
    (the BASELINE benchmark configuration — per-edge Poiseuille resistance).

    Subdivision is uniform (h_c = L_e/N), so every per-cell quantity has a
    closed form in the two (E,) vectors a_e = R_e h_e and F_e = f_e h_e:
    W = a N, cumF_j = F j, g = 1ᵀM·cumF = a F N²/2.  No (C,)-sized array is
    ever materialised on the hot path — the condensation cost drops from
    O(cells) to O(edges) and the only O(dofs) work left is writing the
    solution itself (see ``_backsub_from_lambda``)."""
    mesh = asm.network
    N, E = mesh.N, mesh.num_edges
    dt = R_data.dtype
    h_e = jnp.asarray(mesh.edge_length, dtype=dt) / N
    R_e = R_data[0] * jnp.ones(E, dt) if R_mode == "scalar" else R_data
    f_e = f_data[0] * jnp.ones(E, dt) if f_mode == "scalar" else f_data
    a = R_e * h_e
    F = f_e * h_e
    W = a * N
    Ftot = F * N
    g = a * F * (N * N / 2.0)
    return _EdgeData(
        mt=None,
        cumF=Ftot[:, None],  # only column -1 (= Ftot) is ever read
        W=W,
        g=g,
        start_bif=jnp.asarray(asm._edge_start_bif),
        end_bif=jnp.asarray(asm._edge_end_bif),
        start_pbc=start_pbc,
        end_pbc=end_pbc,
        interior=(),
        rh=None,
        ua=a,
        uF=F,
    )


@functools.lru_cache(maxsize=None)
def _condensed_scalar_constants(
    k: int,
) -> tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Host constants of the degree-k condensed cell matrix.

    For cellwise-constant resistance the cell mass is ``a_c · M̂`` with
    ``M̂`` the fixed reference P_k mass (``elements.mass_matrix``).  Static
    condensation of the interior dofs commutes with the scaling, so the
    condensed endpoint matrix is ``a_c · M̃̂`` with a FIXED
    ``M̃̂ = M̂_EE − M̂_EI M̂_II⁻¹ M̂_IE``, and the interior recovery matrix
    ``M̂_II⁻¹ M̂_IE`` is scale-free — no per-cell Cholesky, no
    ``(C, k+1, k+1)`` tensor anywhere.

    Returns ``(M̃̂ (2, 2), colsum 1ᵀM̃̂ (2,), w̃ = 1ᵀM̃̂1, Minv_IE (k-1, 2))``.
    """
    Mhat = elements.mass_matrix(k)
    if k == 1:
        Mt = Mhat
        Minv = np.zeros((0, 2))
    else:
        ends = [0, k]
        ints = list(range(1, k))
        Minv = np.linalg.solve(Mhat[np.ix_(ints, ints)], Mhat[np.ix_(ints, ends)])
        Mt = Mhat[np.ix_(ends, ends)] - Mhat[np.ix_(ends, ints)] @ Minv
    return Mt, Mt.sum(axis=0), float(Mt.sum()), Minv


def _make_edge_data_scalar(
    asm: _assembly.HydraulicNetworkAssembler,
    cell_scale: jnp.ndarray,
    cell_f_int: jnp.ndarray,
    start_pbc: jnp.ndarray,
    end_pbc: jnp.ndarray,
    f_is_zero: bool = False,
) -> _EdgeData:
    """Scalar-layout edge data: cell mass = a_c * M̂ with a_c = R_c h_c.

    P1 uses the closed forms 1ᵀM̂1 = 1 and 1ᵀM̂ = [1/2, 1/2]; degree ≥ 2
    uses the fixed condensed constants of
    :func:`_condensed_scalar_constants` — either way no ``(C, 2, 2)``
    tensor (or per-cell condensation Cholesky) is ever materialised.
    ``f_is_zero`` (a build-time fact) elides the source cumsums."""
    mesh = asm.network
    N, E = mesh.N, mesh.num_edges
    k = asm.flux_degree
    a = cell_scale.reshape(E, N)
    if k > 1:
        return _make_edge_data_scalar_k(
            asm, a, cell_f_int, start_pbc, end_pbc, f_is_zero
        )
    W = jnp.sum(a, axis=1)
    if f_is_zero:
        cumF = jnp.zeros((E, N + 1), a.dtype)
        g = jnp.zeros(E, a.dtype)
        return _EdgeData(
            mt=None,
            cumF=cumF,
            W=W,
            g=g,
            start_bif=jnp.asarray(asm._edge_start_bif),
            end_bif=jnp.asarray(asm._edge_end_bif),
            start_pbc=start_pbc,
            end_pbc=end_pbc,
            interior=(),
            rh=a,
        )
    F = jnp.broadcast_to(jnp.asarray(cell_f_int), (mesh.num_cells,)).reshape(E, N)
    cumF = jnp.concatenate([jnp.zeros((E, 1), a.dtype), jnp.cumsum(F, axis=1)], axis=1)
    g = 0.5 * jnp.sum(a * (cumF[:, :-1] + cumF[:, 1:]), axis=1)
    return _EdgeData(
        mt=None,
        cumF=cumF,
        W=W,
        g=g,
        start_bif=jnp.asarray(asm._edge_start_bif),
        end_bif=jnp.asarray(asm._edge_end_bif),
        start_pbc=start_pbc,
        end_pbc=end_pbc,
        interior=(),
        rh=a,
    )


def _make_edge_data_scalar_k(
    asm: _assembly.HydraulicNetworkAssembler,
    a: jnp.ndarray,
    cell_f_int: jnp.ndarray,
    start_pbc: jnp.ndarray,
    end_pbc: jnp.ndarray,
    f_is_zero: bool = False,
) -> _EdgeData:
    """Degree-k (k ≥ 2) scalar-layout edge data (see
    :func:`_condensed_scalar_constants`): W = w̃·Σa and
    g = Σ a·(c̃₀ cumF_j + c̃₁ cumF_{j+1}) with fixed condensed constants;
    the interior field carries the fixed scale-free (k-1, 2) recovery
    matrix instead of a per-cell array."""
    mesh = asm.network
    N, E = mesh.N, mesh.num_edges
    _, csum, wt, Minv = _condensed_scalar_constants(asm.flux_degree)
    dt = a.dtype
    W = wt * jnp.sum(a, axis=1)
    interior = (jnp.asarray(Minv, dtype=dt),)
    if f_is_zero:
        cumF = jnp.zeros((E, N + 1), dt)
        g = jnp.zeros(E, dt)
    else:
        F = jnp.broadcast_to(jnp.asarray(cell_f_int), (mesh.num_cells,)).reshape(E, N)
        cumF = jnp.concatenate(
            [jnp.zeros((E, 1), dt), jnp.cumsum(F, axis=1)], axis=1
        )
        # float(): numpy f64 scalars would silently promote f32 arrays
        g = jnp.sum(
            a * (float(csum[0]) * cumF[:, :-1] + float(csum[1]) * cumF[:, 1:]),
            axis=1,
        )
    return _EdgeData(
        mt=None,
        cumF=cumF,
        W=W,
        g=g,
        start_bif=jnp.asarray(asm._edge_start_bif),
        end_bif=jnp.asarray(asm._edge_end_bif),
        start_pbc=start_pbc,
        end_pbc=end_pbc,
        interior=interior,
        rh=a,
    )


def _make_edge_data(
    asm: _assembly.HydraulicNetworkAssembler,
    cell_mass: jnp.ndarray,
    cell_f_int: jnp.ndarray,
    start_pbc: jnp.ndarray,
    end_pbc: jnp.ndarray,
) -> _EdgeData:
    """Condense cell mass blocks and lay out per-edge chain data.

    Pure traced array math — callable inside jit, so the whole
    assemble→condense→solve pipeline fuses into one XLA executable."""
    mesh = asm.network
    k, N, E = asm.flux_degree, mesh.N, mesh.num_edges

    if k == 1:
        mt = cell_mass
        interior: tuple = ()
    else:
        # Static condensation of cell-interior dofs:
        #   M̃ = M_EE − M_EI M_II⁻¹ M_IE ;   q_I = −M_II⁻¹ M_IE q_E
        ends = jnp.array([0, k])
        ints = jnp.arange(1, k)
        M_EE = cell_mass[:, ends][:, :, ends]
        M_EI = cell_mass[:, ends][:, :, ints]
        M_IE = cell_mass[:, ints][:, :, ends]
        M_II = cell_mass[:, ints][:, :, ints]
        L = jnp.linalg.cholesky(M_II)
        Minv_IE = jax.scipy.linalg.cho_solve((L, True), M_IE)
        mt = M_EE - jnp.einsum("cij,cjk->cik", M_EI, Minv_IE, precision=_HI)
        interior = (Minv_IE,)

    mt = mt.reshape(E, N, 2, 2)
    F = cell_f_int.reshape(E, N)
    cumF = jnp.concatenate([jnp.zeros((E, 1), F.dtype), jnp.cumsum(F, axis=1)], axis=1)
    W = jnp.sum(mt, axis=(1, 2, 3))
    # g = 1ᵀ M cumF: each cell contributes colsum(M̃_c) · (cumF_j, cumF_{j+1})
    colsum = jnp.sum(mt, axis=2)  # (E, N, 2)
    cvec = jnp.stack([cumF[:, :-1], cumF[:, 1:]], axis=-1)  # (E, N, 2)
    g = jnp.sum(colsum * cvec, axis=(1, 2))

    return _EdgeData(
        mt=mt,
        cumF=cumF,
        W=W,
        g=g,
        start_bif=jnp.asarray(asm._edge_start_bif),
        end_bif=jnp.asarray(asm._edge_end_bif),
        start_pbc=start_pbc,
        end_pbc=end_pbc,
        interior=interior,
    )


def _prepare_edge_data(asm: _assembly.HydraulicNetworkAssembler) -> _EdgeData:
    """Host-driven edge-data preparation (used by the sharded solver and the
    eager path).

    Selects the same compact layouts as the fused executor (see
    :func:`build_schur_executor`): the uniform closed-form layout for P1 +
    per-edge-constant coefficients (no (C,)-sized arrays at all), the
    scalar ``rh`` layout for P1 + per-cell resistance (16× less HBM
    traffic than the general ``(E, N, 2, 2)`` tensor), and the general
    layout otherwise — so the multi-device path runs the same fast data
    layouts as the serial one."""
    if asm.pressure_degree != 0:
        raise ValueError("schur method requires discontinuous (degree-0) pressure")
    R_mode, f_mode, _ = asm.coefficient_modes()
    start_pbc = jnp.asarray(asm._edge_start_pbc)
    end_pbc = jnp.asarray(asm._edge_end_pbc)
    if asm.flux_degree == 1 and R_mode in ("scalar", "edge") and f_mode in ("scalar", "edge"):
        return _make_edge_data_uniform(
            asm,
            jnp.asarray(asm._R_data),
            jnp.asarray(asm._f_data),
            start_pbc,
            end_pbc,
            R_mode,
            f_mode,
        )
    if R_mode in ("scalar", "edge", "cell"):
        mesh = asm.network
        h = np.asarray(mesh.cell_h)
        if R_mode == "scalar":
            R_cells = np.full(mesh.num_cells, np.asarray(asm._R_data)[0])
        elif R_mode == "edge":
            R_cells = np.asarray(asm._R_data)[mesh.cell_edge]
        else:
            R_cells = np.asarray(asm._R_data)
        return _make_edge_data_scalar(
            asm,
            jnp.asarray(R_cells * h),
            jnp.asarray(asm._cell_f_int),
            start_pbc,
            end_pbc,
        )
    return _make_edge_data(
        asm,
        jnp.asarray(asm._cell_mass),
        jnp.asarray(asm._cell_f_int),
        start_pbc,
        end_pbc,
    )


class _LambdaPlan(typing.NamedTuple):
    """Static sorted-scatter plan for assembling the bifurcation system.

    Sorting the edge→bifurcation incidences once on the host turns the
    (E → B) reductions into sorted segment-sums plus sorted-unique dense
    updates instead of arbitrary-index scatters."""

    t_sel: np.ndarray  # edges with a bifurcation at their target, sorted by it
    t_bins: np.ndarray  # sorted unique target bifurcations
    t_seg: np.ndarray  # segment id of each t_sel entry
    s_sel: np.ndarray
    s_bins: np.ndarray
    s_seg: np.ndarray


def _build_lambda_plan(asm: _assembly.HydraulicNetworkAssembler) -> _LambdaPlan:
    def side(bif: np.ndarray):
        sel = np.flatnonzero(bif >= 0)
        order = sel[np.argsort(bif[sel], kind="stable")]
        bins, seg = np.unique(bif[order], return_inverse=True)
        return order.astype(np.int32), bins.astype(np.int32), seg.astype(np.int32)

    t_sel, t_bins, t_seg = side(asm._edge_end_bif)
    s_sel, s_bins, s_seg = side(asm._edge_start_bif)
    return _LambdaPlan(t_sel, t_bins, t_seg, s_sel, s_bins, s_seg)


def _lambda_system_sorted(ed: _EdgeData, B: int, lp: _LambdaPlan):
    """diag/rhs of the bifurcation system via sorted segment reductions."""
    w = 1.0 / ed.W
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    const = (-ed.start_pbc * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
    Ftot = ed.cumF[:, -1]

    out_diag = jnp.zeros(B, dtype=ed.W.dtype)
    out_rhs = jnp.zeros(B, dtype=ed.W.dtype)
    for vals_d, vals_r, sel, bins, seg in (
        (w, const + Ftot, lp.t_sel, lp.t_bins, lp.t_seg),
        (w, -const, lp.s_sel, lp.s_bins, lp.s_seg),
    ):
        # two-channel fold: (diag, rhs) share the side's segment layout
        both = _segsum_sorted(
            jnp.stack([vals_d, vals_r], axis=-1), seg, len(bins), sel=sel
        )
        bins = np.asarray(bins)
        if bins.size and np.array_equal(
            bins, np.arange(bins[0], bins[0] + bins.size)
        ):
            # contiguous bin range (every multiplier touched on this side —
            # lattices, dense graphs): a static slice-add instead of the
            # B-sized scatter
            lo = int(bins[0])
            out_diag = out_diag.at[lo : lo + bins.size].add(both[:, 0])
            out_rhs = out_rhs.at[lo : lo + bins.size].add(both[:, 1])
        else:
            b_idx = jnp.asarray(bins)
            out_diag = out_diag.at[b_idx].add(
                both[:, 0], indices_are_sorted=True, unique_indices=True
            )
            out_rhs = out_rhs.at[b_idx].add(
                both[:, 1], indices_are_sorted=True, unique_indices=True
            )
    return out_diag, out_rhs


def _directed_half_edges(asm: _assembly.HydraulicNetworkAssembler):
    """The two directed half-edges of every interior (bif-bif) edge:
    ``(own, other, edge_id)`` arrays (shared by the matvec plans)."""
    s = np.asarray(asm._edge_start_bif)
    t = np.asarray(asm._edge_end_bif)
    e = np.flatnonzero((s >= 0) & (t >= 0))
    own = np.concatenate([t[e], s[e]])
    other = np.concatenate([s[e], t[e]])
    edge = np.concatenate([e, e])
    return own, other, edge


def _build_matvec_plan(asm: _assembly.HydraulicNetworkAssembler):
    """Host incidence plan for a scatter-free Laplacian matvec: directed
    half-edges sorted by the owning node so per-node neighbour sums reduce
    via the gather fold."""
    own, other, edge = _directed_half_edges(asm)
    order = np.argsort(own, kind="stable")
    return (
        edge[order].astype(np.int32),
        other[order].astype(np.int32),
        own[order].astype(np.int32),
    )


def _plan_shift_matvec(
    asm: _assembly.HydraulicNetworkAssembler, max_classes: int = 16
):
    """Shift-class decomposition of the λ-graph matvec, or None.

    Groups the directed off-diagonal contributions ``row i ← col j`` by the
    constant index offset ``δ = j − i``.  When few distinct offsets exist
    (lattices: δ ∈ {±1, ±row_stride} plus stubs; chains/banded meshes
    likewise), the per-iteration neighbour lookup becomes, per class, a
    zero-padded SHIFT of λ times a per-class weight vector — contiguous
    slices instead of a device gather per Krylov iteration (the gain is
    not measured on the H100).  The class weight vectors are assembled from the
    runtime conductances once per solve via the sorted fold machinery.

    Returns a list of ``(delta, rows_sorted, edge_sel)`` host arrays.
    """
    own, other, eidx = _directed_half_edges(asm)
    if eidx.size == 0:
        return None
    i, j = own, other  # row pulls from column: out[i] -= w * lam[j]
    delta = j - i
    deltas = np.unique(delta)
    if deltas.size > max_classes:
        return None
    classes = []
    for d in deltas:
        m = delta == d
        rows = i[m]
        order = np.argsort(rows, kind="stable")
        classes.append((int(d), rows[order].astype(np.int32), eidx[m][order]))
    return classes


def _shift_class_weights(ed: _EdgeData, classes, B: int):
    """Per-class (B,) off-diagonal weight vectors from runtime conductances
    (built once per solve, not per iteration)."""
    w = 1.0 / ed.W
    return [(d, _segsum_sorted(w, rows, B, sel=esel)) for d, rows, esel in classes]


def _shift(lam: jnp.ndarray, d: int, m: int) -> jnp.ndarray:
    """Zero-padded shift: out[i] = lam[i+d] (0 outside [0, m))."""
    if d > 0:
        return jnp.concatenate([lam[d:], jnp.zeros(d, dtype=lam.dtype)])
    return jnp.concatenate([jnp.zeros(-d, dtype=lam.dtype), lam[: m + d]])


def _shift_matvec(class_w, diag: jnp.ndarray, m: int):
    """λ ↦ L λ with the off-diagonal apply as per-class weight × shift."""

    def matvec(lam):
        out = diag * lam
        for d, wv in class_w:
            out = out - wv * _shift(lam, d, m)
        return out

    return matvec


def _matvec_from_shift_plan(ed: _EdgeData, diag: jnp.ndarray, classes, B: int):
    return _shift_matvec(_shift_class_weights(ed, classes, B), diag, B)


class _DctPlan(typing.NamedTuple):
    """Host plan for the separable-DCT direct λ solve (see
    :func:`_plan_dct_lattice`)."""

    s: int                    # row stride (lattice width nx)
    ny: int
    rep_x: int                # representative x-edge id (runtime w_x = 1/W)
    rep_y: int
    len_x: float              # geometric x-edge length (κ = W[rep_x]/len_x)
    stub_rows: np.ndarray     # (r,) λ rows carrying boundary-stub coupling
    stub_edge_idx: np.ndarray  # stub edge ids (runtime w_r = Σ 1/W)
    stub_edge_group: np.ndarray  # group index (into stub_rows) per stub edge
    g_geo: np.ndarray         # (r, B) geometric L⁺ columns at the stub rows
    lamx: np.ndarray          # (s,) Neumann path eigenvalues 2−2cos(πk/s)
    lamy: np.ndarray


def _plan_dct_lattice(asm: _assembly.HydraulicNetworkAssembler, shift_plan):
    """Exact direct λ solve plan for uniform rectangular lattices, or None.

    When the multiplier graph is a uniform rectangular grid (the
    `make_grid` capillary-mesh family) with scalar resistance, the Schur
    Laplacian separates:  ``L = w_x (I ⊗ Lx) + w_y (Ly ⊗ I) + D_s`` with
    ``Lx/Ly`` 1-D Neumann path Laplacians (diagonalised by the
    orthonormal DCT-II: eigenvalues ``2 − 2cos(πk/n)``) and ``D_s`` the
    boundary-stub diagonal coupling at r ≪ B rows.  λ then solves EXACTLY
    in O(B log B) by the capacitance-matrix method: one 2-D DCT solve of
    the singular separable part (zero mode dropped) plus an (r+1)×(r+1)
    bordered system for the stub charges and the additive constant —
    replacing the ~13–16 MG-preconditioned CG iterations the general path
    needs.  Structure checks are host-side and build-time: four shift
    classes {±1, ±s} with the exact grid row patterns, uniform edge
    length per class, and ≤ 16 stub rows."""
    if shift_plan is None:
        return None
    deltas = sorted(c[0] for c in shift_plan)
    if len(deltas) != 4:
        return None
    s = deltas[3]
    if deltas != [-s, -1, 1, s] or s <= 2:
        return None
    mesh = asm.network
    B = mesh.num_multipliers
    if B % s != 0:
        return None
    ny = B // s
    if ny < 2:
        return None
    idx = np.arange(B)
    want = {
        1: idx[idx % s != s - 1],
        -1: idx[idx % s != 0],
        s: idx[: B - s],
        -s: idx[s:],
    }
    L_all = np.asarray(mesh.edge_length)
    lens: dict[int, float] = {}
    rep: dict[int, int] = {}
    for d, rows, esel in shift_plan:
        if not np.array_equal(np.sort(rows), want[d]):
            return None
        Ld = L_all[esel]
        if Ld.size == 0 or not np.allclose(Ld, Ld[0], rtol=1e-12, atol=0.0):
            return None
        prev = lens.get(abs(d))
        if prev is not None and not np.isclose(prev, Ld[0], rtol=1e-12):
            return None
        lens[abs(d)] = float(Ld[0])
        rep[d] = int(esel[0])
    # boundary stubs: edges with exactly one multiplier endpoint
    sb = np.asarray(asm._edge_start_bif)
    eb = np.asarray(asm._edge_end_bif)
    one = (sb >= 0) ^ (eb >= 0)
    stub_e = np.nonzero(one)[0]
    if stub_e.size == 0 or stub_e.size > 16:
        return None
    stub_row = np.where(sb[stub_e] >= 0, sb[stub_e], eb[stub_e])
    rows_u, group = np.unique(stub_row, return_inverse=True)

    import scipy.fft as _sfft

    lamx = 2.0 - 2.0 * np.cos(np.pi * np.arange(s) / s)
    lamy = 2.0 - 2.0 * np.cos(np.pi * np.arange(ny) / ny)
    sym = (1.0 / lens[1]) * lamx[None, :] + (1.0 / lens[s]) * lamy[:, None]
    sym[0, 0] = np.inf
    g = np.empty((rows_u.size, B))
    for t, row in enumerate(rows_u):
        e = np.zeros(B)
        e[int(row)] = 1.0
        c = _sfft.dctn(e.reshape(ny, s), type=2, norm="ortho") / sym
        g[t] = _sfft.idctn(c, type=2, norm="ortho").reshape(-1)
    return _DctPlan(
        s, ny, rep[1], rep[s], lens[1],
        rows_u.astype(np.int64), stub_e.astype(np.int64),
        group.astype(np.int64), g, lamx, lamy,
    )


def _dct_lattice_solve(plan: _DctPlan, ed: _EdgeData, rhs: jnp.ndarray, matvec):
    """Device-side exact λ solve on the DCT plan (see _plan_dct_lattice).

    Reads the runtime conductance scalars from the general-path edge data
    and delegates to :func:`_dct_capacitance_solve`."""
    wx = 1.0 / ed.W[plan.rep_x]
    wy = 1.0 / ed.W[plan.rep_y]
    r = int(plan.stub_rows.size)
    w_r = jnp.zeros(r, rhs.dtype).at[jnp.asarray(plan.stub_edge_group)].add(
        1.0 / ed.W[jnp.asarray(plan.stub_edge_idx)]
    )
    return _dct_capacitance_solve(plan, wx, wy, w_r, rhs, matvec)


def _dct_capacitance_factor(plan: _DctPlan, wx, wy, w_r: jnp.ndarray, dt):
    """Conductance-side state of the capacitance solve: the scaled
    separable eigenvalue inverse, the runtime-scaled L⁺ stub columns, and
    the polished inverse of the bordered system.  Reusable across right-
    hand sides (the factor half of :func:`_dct_capacitance_solve`)."""
    sym = wx * jnp.asarray(plan.lamx, dt)[None, :] + wy * jnp.asarray(
        plan.lamy, dt
    )[:, None]
    pos = sym > 0
    inv = jnp.where(pos, 1.0 / jnp.where(pos, sym, 1.0), 0.0)
    kappa = 1.0 / (wx * plan.len_x)
    g = kappa * jnp.asarray(plan.g_geo, dt)  # (r, B)
    M = _bordered_capacitance(plan, g, w_r)
    return {"inv": inv, "g": g, "Minv": jnp.linalg.inv(M)}


def _bordered_capacitance(plan: _DctPlan, g: jnp.ndarray, w_r: jnp.ndarray):
    """The (r+1)² bordered capacitance system: stub charges q_r =
    w_r·λ[row_r] plus the additive constant γ of the pseudo-inverse (range
    condition 1ᵀ(b−Uq)=0)."""
    r = int(plan.stub_rows.size)
    M = jnp.zeros((r + 1, r + 1), g.dtype)
    M = M.at[:r, :r].set(g[:, plan.stub_rows].T + jnp.diag(1.0 / w_r))
    M = M.at[:r, r].set(-1.0)
    return M.at[r, :r].set(1.0)


def _dct_capacitance_solve(
    plan: _DctPlan, wx, wy, w_r: jnp.ndarray, rhs: jnp.ndarray, matvec
):
    """Exact λ solve given runtime scalars (see _plan_dct_lattice).

    The geometric L⁺ columns scale to runtime conductances by
    κ = 1/(w_x·len_x) (scalar resistance makes the whole separable part
    a uniform multiple of the geometric operator).  Refinement passes
    with the exact matvec grind the transform roundoff down to direct-
    solve accuracy.  Split into :func:`_dct_capacitance_factor` (conductance side) and
    :func:`_dct_capacitance_apply` (per-rhs) for factor-reuse serving."""
    state = _dct_capacitance_factor(plan, wx, wy, w_r, rhs.dtype)
    return _dct_capacitance_apply(plan, state, rhs, matvec)


def _dct2_matrix_device(n: int, tdt) -> jnp.ndarray:
    """Orthonormal DCT-II matrix generated ON DEVICE from iota.

    Used for wide lattices (> 4096 per side) where an ``(n, n)`` f64 host
    constant would bake hundreds of MB into the executable.  The cosine
    ARGUMENT must form in f64 even when a f32 matrix is requested (float32
    serving): ``pi*(j+0.5)*j`` reaches ~n²/2 ≈ 1e7+ here, so
    an f32 product carries ~2e-3 rad of phase error — four orders worse
    than rounding an f64-generated matrix to f32.
    ``c = D @ b``, ``b = D.T @ c``."""
    j = jnp.arange(n, dtype=jnp.float64)
    D = jnp.cos(jnp.pi * ((j[None, :] + 0.5) * j[:, None] / n))
    D = D * np.sqrt(2.0 / n)
    D = D.at[0].multiply(np.sqrt(0.5))
    return D.astype(tdt)


def _dct_capacitance_apply(
    plan: _DctPlan, state: dict, rhs: jnp.ndarray, matvec
):
    """Per-rhs half of the capacitance solve (see _dct_capacitance_solve)."""
    dt = rhs.dtype
    s, ny = plan.s, plan.ny
    inv = state["inv"]
    g = state["g"]
    Minv = state["Minv"]
    r = int(plan.stub_rows.size)
    # Matmul DCT: the separable transform as two (n, n) matmuls per axis,
    # in the compute dtype with HIGHEST precision (no TF32 passes for f32).
    # The transform matrices come from one of two providers — a host
    # constant up to 4096 per side, or on-device generation from iota
    # above it (an (n, n) f64 host constant at that size would bake
    # hundreds of MB into the executable).  ONE shared Lplus body serves
    # both so a precision/normalization fix can never drift between them.

    def _make_D(n: int) -> jnp.ndarray:
        if max(s, ny) > 4096:
            return _dct2_matrix_device(n, dt)  # see its argument-precision rule
        j = np.arange(n)
        D = np.cos(np.pi * (j[None, :] + 0.5) * j[:, None] / n)
        D *= np.sqrt(2.0 / n)
        D[0] *= np.sqrt(0.5)
        return jnp.asarray(D, dt)  # orthonormal DCT-II: c = D@b, b = D.T@c

    Dx = _make_D(s)
    Dy = _make_D(ny)
    mm = functools.partial(jnp.matmul, precision=_HI)

    def Lplus(b):
        c = mm(mm(Dy, b.reshape(ny, s)), Dx.T)
        return mm(mm(Dy.T, c * inv), Dx).reshape(-1)

    rows = jnp.asarray(plan.stub_rows)

    def direct(b):
        z = Lplus(b)
        v = jnp.concatenate([z[rows], jnp.sum(b)[None]])
        sol = mm(Minv, v)
        corr = jnp.sum(sol[:r, None] * g, axis=0)
        return z - corr + sol[r]

    # refinement passes: contraction ≈ κ·ε_trans per pass (κ ~ O(n²) for
    # an n-wide lattice), so two passes grind out roundoff; the residual
    # stays surfaced in SolveInfo regardless.
    n_refine = 2
    lam = direct(rhs)
    for _ in range(n_refine):
        lam = lam + direct(rhs - matvec(lam))
    return lam


class _GridPlan(typing.NamedTuple):
    """Host plan for the lattice-internal edge layout (see
    :func:`_plan_grid_layout`)."""

    nx: int
    ny: int
    edge_order: np.ndarray    # (E,) internal position -> public edge id
    Ex: int                   # x-edges: rows 0..Ex, (ny, nx-1) row-major
    Ey: int                   # y-edges: rows Ex..Ex+Ey, (ny-1, nx) row-major
    s_is_bif: np.ndarray      # (E,) internal-order endpoint masks
    t_is_bif: np.ndarray
    stub_rows_e: np.ndarray   # (n_stub,) λ row of each stub edge (tail order)
    stub_s_bif: np.ndarray    # (n_stub,) True when the bif end is the START
    stub_group: np.ndarray    # (n_stub,) index into dct.stub_rows
    h_e: np.ndarray           # (E,) internal-order cell lengths (L/N)
    dct: "_DctPlan"
    bif_order: None = None    # λ stays in node order (flatten no-op)


def _plan_grid_layout(asm: _assembly.HydraulicNetworkAssembler, dct: _DctPlan):
    """Lattice-internal edge order, or None.

    Companion to :func:`_plan_dct_lattice` (which proves the multiplier
    graph is a uniform nx×ny grid): reorders edges into [x-edges (ny,
    nx−1) row-major | y-edges (ny−1, nx) row-major | boundary stubs] so
    every structural map in the fused solve — Schur rhs assembly, the
    refinement-matvec stencil, and the λ→edge-endpoint expansion —
    becomes a 2-D SLICE of the λ grid instead of an E-sized device
    gather/scatter (the gain is not measured on the H100).  The same prepare-args/host-flatten
    machinery as the forest blocked layout applies (``_BlockedExecutor``)."""
    nx, ny = dct.s, dct.ny
    mesh = asm.network
    E = mesh.num_edges
    Ex, Ey = ny * (nx - 1), (ny - 1) * nx
    sb = np.asarray(asm._edge_start_bif)
    eb = np.asarray(asm._edge_end_bif)
    both = (sb >= 0) & (eb >= 0)
    d = np.where(both, eb - sb, 0)
    is_x = both & (d == 1)
    is_y = both & (d == nx)
    if np.any(both & ~is_x & ~is_y):
        return None  # reversed or non-grid edge: layout inapplicable
    slots = np.full(Ex + Ey, -1, dtype=np.int64)
    sx = sb[is_x]
    slots[(sx // nx) * (nx - 1) + sx % nx] = np.nonzero(is_x)[0]
    slots[Ex + sb[is_y]] = np.nonzero(is_y)[0]
    if np.any(slots < 0):
        return None
    stubs = np.nonzero(~both)[0]
    if np.any((sb[stubs] < 0) & (eb[stubs] < 0)):
        return None  # fully-boundary edge: not a lattice stub
    edge_order = np.concatenate([slots, stubs])
    if edge_order.size != E:
        return None
    stub_rows_e = np.where(sb[stubs] >= 0, sb[stubs], eb[stubs])
    # group index into the dct plan's unique stub rows
    pos = {int(r): i for i, r in enumerate(dct.stub_rows)}
    try:
        stub_group = np.array([pos[int(r)] for r in stub_rows_e], dtype=np.int64)
    except KeyError:  # pragma: no cover - dct plan guarantees coverage
        return None
    return _GridPlan(
        nx=nx,
        ny=ny,
        edge_order=edge_order,
        Ex=Ex,
        Ey=Ey,
        s_is_bif=(sb[edge_order] >= 0),
        t_is_bif=(eb[edge_order] >= 0),
        stub_rows_e=stub_rows_e.astype(np.int64),
        stub_s_bif=(sb[stubs] >= 0),
        stub_group=stub_group,
        h_e=np.asarray(mesh.edge_length)[edge_order] / mesh.N,
        dct=dct,
    )


def _grid_blocked_core(
    asm: _assembly.HydraulicNetworkAssembler,
    plan: _GridPlan,
    R_mode: str,
    f_mode: str,
    comp_dt,
    out_dt,
):
    """Fused gather-free lattice solve: condense → 2-D slice assembly →
    DCT capacitance λ solve (stencil-matvec refinement) → slice λ
    expansion → back-substitution.  Args/outputs in INTERNAL edge order
    (``_BlockedExecutor.prepare_args`` / host flatten)."""
    mesh = asm.network
    N, E = mesh.N, mesh.num_edges
    nx, ny, Ex, Ey = plan.nx, plan.ny, plan.Ex, plan.Ey
    k = asm.flux_degree
    h_e = jnp.asarray(plan.h_e, dtype=comp_dt)
    s_b = jnp.asarray(plan.s_is_bif)
    t_b = jnp.asarray(plan.t_is_bif)
    n_stub = int(plan.stub_rows_e.size)
    stub_rows = jnp.asarray(plan.stub_rows_e)
    stub_s = jnp.asarray(plan.stub_s_bif)
    r_dct = int(plan.dct.stub_rows.size)

    def core(arg0, arg1, start_pbc, end_pbc):
        arg0 = jnp.asarray(arg0, dtype=comp_dt)
        arg1 = jnp.asarray(arg1, dtype=comp_dt)
        spbc = jnp.asarray(start_pbc, dtype=comp_dt)
        epbc = jnp.asarray(end_pbc, dtype=comp_dt)
        W, g, Ftot, back = _blocked_condense(
            N, E, h_e, arg0, arg1, R_mode, f_mode, k=k
        )
        w = 1.0 / W
        const = (-spbc * (~s_b) + epbc * (~t_b) - g) * w
        cF = const + Ftot

        # 2-D views of the two rectangular edge blocks
        def x2d(v):
            return v[:Ex].reshape(ny, nx - 1)

        def y2d(v):
            return v[Ex : Ex + Ey].reshape(ny - 1, nx)

        # Schur rhs: target-node += cF, source-node -= const — pure
        # 2-D slice adds (the general path's B-sized scatter/segment fold)
        rhs2 = jnp.zeros((ny, nx), comp_dt)
        rhs2 = rhs2.at[:, 1:].add(x2d(cF))
        rhs2 = rhs2.at[:, : nx - 1].add(-x2d(const))
        rhs2 = rhs2.at[1:, :].add(y2d(cF))
        rhs2 = rhs2.at[: ny - 1, :].add(-y2d(const))
        # diagonal: w of every incident edge
        wx2, wy2 = x2d(w), y2d(w)
        diag2 = jnp.zeros((ny, nx), comp_dt)
        diag2 = diag2.at[:, : nx - 1].add(wx2)
        diag2 = diag2.at[:, 1:].add(wx2)
        diag2 = diag2.at[: ny - 1, :].add(wy2)
        diag2 = diag2.at[1:, :].add(wy2)
        if n_stub:
            w_st = w[Ex + Ey :]
            cF_st = cF[Ex + Ey :]
            const_st = const[Ex + Ey :]
            rhs_st = jnp.where(stub_s, -const_st, cF_st)
            rhs2 = rhs2.reshape(-1).at[stub_rows].add(rhs_st).reshape(ny, nx)
            diag2 = diag2.reshape(-1).at[stub_rows].add(w_st).reshape(ny, nx)
        rhs = rhs2.reshape(-1)

        def matvec(lam):
            l2 = lam.reshape(ny, nx)
            out = diag2 * l2
            out = out.at[:, : nx - 1].add(-wx2 * l2[:, 1:])
            out = out.at[:, 1:].add(-wx2 * l2[:, : nx - 1])
            out = out.at[: ny - 1, :].add(-wy2 * l2[1:, :])
            out = out.at[1:, :].add(-wy2 * l2[: ny - 1, :])
            return out.reshape(-1)

        w_r = jnp.zeros(r_dct, comp_dt)
        if n_stub:
            w_r = w_r.at[jnp.asarray(plan.stub_group)].add(w[Ex + Ey :])
        lam = _dct_capacitance_solve(plan.dct, w[0], w[Ex], w_r, rhs, matvec)

        # λ → edge endpoints: 2-D slices (+ tiny stub gather)
        l2 = lam.reshape(ny, nx)
        parts_s = [l2[:, : nx - 1].reshape(-1), l2[: ny - 1, :].reshape(-1)]
        parts_t = [l2[:, 1:].reshape(-1), l2[1:, :].reshape(-1)]
        if n_stub:
            lam_st = lam[stub_rows]
            parts_s.append(jnp.where(stub_s, lam_st, 0.0))
            parts_t.append(jnp.where(stub_s, 0.0, lam_st))
        lam_s = jnp.concatenate(parts_s)
        lam_t = jnp.concatenate(parts_t)

        r0 = jnp.where(s_b, lam_s, -spbc)
        rN = jnp.where(t_b, -lam_t, epbc)
        q0 = (r0 + rN - g) * w
        q_T, p_T = back(q0, r0)
        residual = jnp.linalg.norm(matvec(lam) - rhs)
        rhs_norm = jnp.linalg.norm(rhs)
        finite = (
            jnp.all(jnp.isfinite(q0))
            & jnp.all(jnp.isfinite(r0))
            & jnp.all(jnp.isfinite(lam))
            & jnp.all(jnp.isfinite(W))
            & jnp.all(jnp.isfinite(g))
            & jnp.all(jnp.isfinite(Ftot))
        )
        iters = jnp.zeros((), dtype=jnp.int32)
        return (
            q_T.astype(out_dt),
            p_T.astype(out_dt),
            lam.astype(out_dt),
            iters,
            residual,
            rhs_norm,
            finite,
        )

    return core


def _mg2d_feasible(B: int, stride: int, max_coarsest: int = 4096) -> bool:
    """Host check that 2×2 coarsening reaches a small coarsest grid.

    Skinny lattices (one dimension ≤ 4) stop coarsening immediately and
    would materialise a huge dense coarsest system (``jnp.diag`` of a
    B-sized vector + per-solve Cholesky)."""
    ny, nx = B // stride, stride
    while min(ny, nx) > 4 and ny * nx > 256:
        ny, nx = (ny + 1) // 2, (nx + 1) // 2
    return ny * nx <= max_coarsest


def _mg2d_preconditioner(
    class_w0,
    diag0: jnp.ndarray,
    B: int,
    stride: int,
    smooth_degree: int = 3,
    overcorrect: float = 1.8,
):
    """Symmetric 2-D geometric-multigrid V-cycle for {±1, ±stride} classes.

    The class set reveals the row-major lattice shape (nx = stride,
    ny = B/stride); 2×2 aggregation then coarsens BOTH axes (plain 1-D
    index pairing only semicoarsens — iteration counts kept growing with
    n).  All transfers are reshape-block sums and the per-level operator
    stays four weight arrays × four 2-D shifts; the coarsest banded
    Laplacian is solved by Cholesky.  Gives ~grid-independent PCG
    iteration counts on capillary-mesh lattices."""
    from .ops import krylov

    ny0, nx0 = B // stride, stride
    dt = diag0.dtype

    def to2d(v):
        return v.reshape(ny0, nx0)

    # direction arrays E(+1) W(-1) S(+nx) N(-nx); absent classes are zero
    dirs = {1: "E", -1: "W", stride: "S", -stride: "N"}
    w2 = {k: jnp.zeros((ny0, nx0), dtype=dt) for k in ("E", "W", "S", "N")}
    for d, wv in class_w0:
        w2[dirs[d]] = to2d(wv)
    extra = to2d(diag0) - (w2["E"] + w2["W"] + w2["S"] + w2["N"])

    def pad_even(a):
        py = a.shape[0] % 2
        px = a.shape[1] % 2
        if py or px:
            a = jnp.pad(a, ((0, py), (0, px)))
        return a

    def blocks(a):
        """(ny, nx) -> (ny/2, 2, nx/2, 2) after even-padding."""
        a = pad_even(a)
        return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)

    levels = []  # (shape, w2 dict, diag2d)
    while min(extra.shape) > 4 and extra.size > 256:
        diag2d = extra + w2["E"] + w2["W"] + w2["S"] + w2["N"]
        # padded cells carry zero diagonal — decouple them (the smoother
        # Jacobi-scales by 1/sqrt(diag))
        diag2d = jnp.where(diag2d > 0, diag2d, 1.0)
        levels.append((extra.shape, dict(w2), diag2d))
        bE, bW = blocks(w2["E"]), blocks(w2["W"])
        bS, bN = blocks(w2["S"]), blocks(w2["N"])
        w2 = {
            # crossings out of the 2x2 block survive; intra-block vanish
            "E": bE[:, 0, :, 1] + bE[:, 1, :, 1],
            "W": bW[:, 0, :, 0] + bW[:, 1, :, 0],
            "S": bS[:, 1, :, 0] + bS[:, 1, :, 1],
            "N": bN[:, 0, :, 0] + bN[:, 0, :, 1],
        }
        extra = blocks(extra).sum(axis=(1, 3))
    diag_bot2 = extra + w2["E"] + w2["W"] + w2["S"] + w2["N"]
    diag_bot2 = jnp.where(diag_bot2 > 0, diag_bot2, 1.0)  # padded dummy rows
    nyb, nxb = diag_bot2.shape
    mb = nyb * nxb
    Lc = jnp.diag(diag_bot2.reshape(mb))
    for key, off in (("E", 1), ("W", -1), ("S", nxb), ("N", -nxb)):
        wv = w2[key].reshape(mb)
        if off > 0:
            Lc = Lc - jnp.diag(wv[: mb - off], k=off)
        else:
            Lc = Lc - jnp.diag(wv[-off:], k=off)
    chol_c = jnp.linalg.cholesky(Lc)

    def mk_matvec(wd, dg):
        def shift2(v, dy, dx):
            return jnp.pad(v, ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))))[
                max(dy, 0) : v.shape[0] + max(dy, 0),
                max(dx, 0) : v.shape[1] + max(dx, 0),
            ]

        def mv(v):
            return (
                dg * v
                - wd["E"] * shift2(v, 0, 1)
                - wd["W"] * shift2(v, 0, -1)
                - wd["S"] * shift2(v, 1, 0)
                - wd["N"] * shift2(v, -1, 0)
            )

        return mv

    matvecs = [mk_matvec(wd, dg) for _, wd, dg in levels]
    smoothers = [
        krylov.chebyshev_preconditioner(mv, dg, degree=smooth_degree, ratio=4.0)
        for mv, (_, _, dg) in zip(matvecs, levels)
    ]

    def restrict(res):
        return blocks(res).sum(axis=(1, 3))

    def prolong(ec, shape):
        up = jnp.repeat(jnp.repeat(ec, 2, axis=0), 2, axis=1)
        return up[: shape[0], : shape[1]]

    def vcycle(lvl, r):
        if lvl == len(levels):
            return jax.scipy.linalg.cho_solve(
                (chol_c, True), r.reshape(mb)
            ).reshape(r.shape)
        mv, sm = matvecs[lvl], smoothers[lvl]
        shape = levels[lvl][0]
        x = sm(r)
        rc = restrict(r - mv(x))
        # plain-aggregation coarse corrections are systematically too weak
        # (the PWC Galerkin operator is ~2x too stiff on 2-D Poisson-like
        # problems); the standard over-correction restores near-grid-
        # independent convergence while keeping the operator symmetric
        # (SolverOptions.mg_overcorrect, default 1.8).
        x = x + overcorrect * prolong(vcycle(lvl + 1, rc), shape)
        x = x + sm(r - mv(x))
        return x

    return lambda r: vcycle(0, to2d(r)).reshape(B)


def _plan_mg(
    deltas, B: int, coarsest: int = 512, max_classes: int = 16
):
    """Host plan for the shift-preserving pairwise-aggregation multigrid.

    Aggregating consecutive index pairs (agg(i) = i//2) maps a directed
    shift-class contribution ``row i ← i+δ`` to the coarse contribution
    ``row i//2 ← i//2 + Δ`` with ``Δ = floor((p + δ)/2)`` for parity
    ``p = i mod 2``; ``Δ = 0`` terms are intra-aggregate and vanish from
    the Galerkin (piecewise-constant) coarse operator, which for a graph
    Laplacian is exactly the contracted-graph Laplacian.  Row-major
    lattices keep classes {±1, ±n/2} at every level, so the whole V-cycle
    stays in the cheap slice/shift idiom.

    Returns (levels, coarsest_m, coarsest_classes) or None; each level is
    ``(m, classes, mapping, mc)`` with ``mapping`` a tuple of
    ``(Δ, ((class_index, parity), ...))``.
    """
    levels = []
    classes = tuple(sorted(int(d) for d in deltas))
    m = B
    while m > coarsest:
        mc = (m + 1) // 2
        mapping: dict[int, list] = {}
        for ci, d in enumerate(classes):
            for p in (0, 1):
                D = (p + d) // 2
                if D != 0:
                    mapping.setdefault(D, []).append((ci, p))
        if len(mapping) > max_classes:
            break
        levels.append(
            (m, classes, tuple(sorted((k, tuple(v)) for k, v in mapping.items())), mc)
        )
        classes = tuple(sorted(mapping.keys()))
        m = mc
    if not levels:
        return None
    return levels, m, classes


def _mg_preconditioner(
    mg_plan,
    class_w0,
    diag0: jnp.ndarray,
    B: int,
    smooth_degree: int = 3,
    overcorrect: float = 1.8,
):
    """Symmetric V-cycle preconditioner over the shift-class hierarchy.

    All transfers are pad/reshape/repeat on shrinking arrays; smoothing is
    dot-free Chebyshev on [λmax/4, λmax] of each level's Jacobi-scaled
    operator; the coarsest level materialises the banded Laplacian from
    its class vectors (``jnp.diag`` per offset) and solves by Cholesky.
    Grid-independent PCG iteration counts replace CG's O(n) growth on
    lattices."""
    from .ops import krylov

    levels_host, m_bot, classes_bot = mg_plan

    def pad_even(v, mc):
        need = 2 * mc - v.shape[0]
        return jnp.concatenate([v, jnp.zeros(need, dtype=v.dtype)]) if need else v

    # Build the per-level class weights, extras and diags top-down.
    level_data = []  # (m, class_w dict-as-list, diag)
    cw = list(class_w0)
    diag = diag0
    extra = diag0 - sum(w for _, w in cw)  # boundary diagonal excess
    for m, classes, mapping, mc in levels_host:
        level_data.append((m, cw, diag))
        by_idx = {ci: w for ci, (_, w) in enumerate(cw)}
        cw_c = []
        for D, contribs in mapping:
            acc = jnp.zeros(mc, dtype=diag.dtype)
            for ci, p in contribs:
                acc = acc + pad_even(by_idx[ci], mc)[p::2]
            cw_c.append((D, acc))
        extra = pad_even(extra, mc).reshape(mc, 2).sum(axis=1)
        diag = extra + sum(w for _, w in cw_c)
        cw = cw_c
    # coarsest: dense banded Laplacian + Cholesky
    Lc = jnp.diag(diag)
    for d, wv in cw:
        if d > 0:
            Lc = Lc - jnp.diag(wv[: m_bot - d], k=d)
        else:
            Lc = Lc - jnp.diag(wv[-d:], k=d)
    chol_c = jnp.linalg.cholesky(Lc)

    smoothers = [
        krylov.chebyshev_preconditioner(
            _shift_matvec(cwl, dl, ml), dl, degree=smooth_degree, ratio=4.0
        )
        for ml, cwl, dl in level_data
    ]
    matvecs = [_shift_matvec(cwl, dl, ml) for ml, cwl, dl in level_data]

    def vcycle(lvl, r):
        if lvl == len(level_data):
            return jax.scipy.linalg.cho_solve((chol_c, True), r)
        mv = matvecs[lvl]
        sm = smoothers[lvl]
        m = level_data[lvl][0]
        mc = (m + 1) // 2
        x = sm(r)
        res = r - mv(x)
        rc = pad_even(res, mc).reshape(mc, 2).sum(axis=1)
        ec = vcycle(lvl + 1, rc)
        # over-correct: plain-aggregation Galerkin coarse operators are
        # too stiff (same rationale as the 2-D cycle; see
        # SolverOptions.mg_overcorrect)
        x = x + overcorrect * jnp.repeat(ec, 2)[:m]
        x = x + sm(r - mv(x))
        return x

    return lambda r: vcycle(0, r)


def _matvec_from_plan(ed: _EdgeData, diag: jnp.ndarray, plan, B: int):
    """λ ↦ L λ with the off-diagonal apply as gather + fold (no scatter).

    The neighbour lookup runs EVERY Krylov iteration, so the host-static
    incidence map goes through :func:`_structured_take` first — lattice
    networks produce strided neighbour maps that lower to strided slices."""
    edge_sel, other_sel, own_sorted = plan
    w = 1.0 / ed.W
    w_sel = _structured_take(w, edge_sel)
    w_inc = w[jnp.asarray(edge_sel)] if w_sel is None else w_sel
    other_dev = jnp.asarray(other_sel)

    def matvec(lam):
        lam_nb = _structured_take(lam, other_sel)
        if lam_nb is None:
            lam_nb = lam[other_dev]
        contrib = -w_inc * lam_nb
        return diag * lam + _segsum_sorted(contrib, own_sorted, B)

    return matvec


def _schur_lambda_system(ed: _EdgeData, B: int):
    """Weighted bifurcation-graph Laplacian L and RHS for  L λ = rhs."""
    w = 1.0 / ed.W
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    s_idx = jnp.where(s_is_bif, ed.start_bif, 0)
    t_idx = jnp.where(t_is_bif, ed.end_bif, 0)

    # const part of q0 (boundary data and source term):
    const = (ed.start_pbc * (-1.0) * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
    Ftot = ed.cumF[:, -1]

    # rhs_b = Σ_in (const + Ftot) − Σ_out const   (see module docstring)
    rhs = jnp.zeros(B, dtype=ed.W.dtype)
    rhs = rhs.at[t_idx].add(jnp.where(t_is_bif, const + Ftot, 0.0))
    rhs = rhs.at[s_idx].add(jnp.where(s_is_bif, -const, 0.0))

    diag = jnp.zeros(B, dtype=ed.W.dtype)
    diag = diag.at[t_idx].add(jnp.where(t_is_bif, w, 0.0))
    diag = diag.at[s_idx].add(jnp.where(s_is_bif, w, 0.0))

    both = s_is_bif & t_is_bif
    off_w = jnp.where(both, w, 0.0)

    def matvec(lam):
        out = diag * lam
        # gather neighbour values through the edges with both ends interior
        out = out.at[s_idx].add(-off_w * lam[t_idx] * both)
        out = out.at[t_idx].add(-off_w * lam[s_idx] * both)
        return out

    return matvec, diag, rhs, (s_idx, t_idx, off_w, both)


class _TreePlan(typing.NamedTuple):
    """Static peel-then-core elimination plan for the bifurcation graph.

    Degree-≤1 nodes eliminate fill-in-free in rounds (exact for forests —
    every reference benchmark network); whatever cycle core remains is
    solved densely on its (usually tiny) reduced system.  All structure is
    host-precomputed; only runtime conductances flow through the device
    program.
    """

    pair_nodes: np.ndarray  # (P, 2) bifurcation index pairs with >=1 edge
    edge_pair: np.ndarray  # (E,) pair id of each graph edge, -1 if not bif-bif
    rounds: tuple  # tuple of (elim_nodes, parents, pair_ids) int32 arrays
    core_nodes: np.ndarray = np.empty(0, np.int32)  # un-peeled (cycle) nodes
    core_pairs: np.ndarray = np.empty((0, 3), np.int32)  # (ci, cj, pair_id)
    # Optional sparse (min-degree independent-set) elimination of the cycle
    # core — MUMPS-generality for large unstructured cores; attached lazily
    # via attach_core_plan() because the symbolic phase costs host time.
    core_plan: "object | None" = None

    @property
    def core_size(self) -> int:
        return int(self.core_nodes.size)


def _plan_tree_elimination(
    asm: _assembly.HydraulicNetworkAssembler, force_rounds: bool = False
) -> _TreePlan | None:
    """Build the peel order plus the residual cycle core (empty for forests).

    ``force_rounds=True`` computes the Python peel rounds even for forests
    (the fast path below otherwise returns ``rounds=()`` because the level
    plan supersedes them on the fused path).  Consumers that execute the
    rounds directly — :class:`TreeFactorization` — must pass it, or a
    forest would silently eliminate nothing and return λ = 0."""
    mesh = asm.network
    B = mesh.num_multipliers
    if B == 0:
        return _TreePlan(np.empty((0, 2), np.int64), np.full(mesh.num_edges, -1, np.int64), ())

    s_bif = asm._edge_start_bif
    t_bif = asm._edge_end_bif
    both = (s_bif >= 0) & (t_bif >= 0)
    a = np.minimum(s_bif[both], t_bif[both])
    b = np.maximum(s_bif[both], t_bif[both])
    pairs, pair_of_bb = np.unique(np.stack([a, b], 1), axis=0, return_inverse=True)
    edge_pair = np.full(mesh.num_edges, -1, dtype=np.int64)
    edge_pair[both] = pair_of_bb
    P = pairs.shape[0]

    # Forest fast path: a graph is a forest iff #pairs == #nodes − #components;
    # the peel rounds are then never consulted (the level plan supersedes
    # them), so skip the Python peel loop entirely.
    if P > 0:
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import connected_components as _cc

        adjm = _sp.coo_matrix((np.ones(P), (pairs[:, 0], pairs[:, 1])), shape=(B, B))
        n_comp = _cc(adjm, directed=False)[0]
    else:
        n_comp = B
    if P == B - n_comp and not force_rounds:
        return _TreePlan(pairs, edge_pair, ())

    # adjacency over pairs
    adj: list[dict[int, int]] = [dict() for _ in range(B)]  # node -> {nbr: pair}
    for p_id, (u, v) in enumerate(pairs):
        adj[u][v] = p_id
        adj[v][u] = p_id
    degree = np.array([len(d) for d in adj])
    alive = np.ones(B, dtype=bool)
    rounds = []
    remaining = B
    while remaining > 0:
        cand = np.flatnonzero(alive & (degree <= 1))
        if cand.size == 0:
            break  # cycle core remains; handled densely below
        # independent set: skip a leaf whose (leaf) neighbour has lower id
        chosen = []
        cand_set = set(int(c) for c in cand)
        for c in cand:
            nbrs = [n for n in adj[c] if alive[n]]
            if nbrs and nbrs[0] in cand_set and nbrs[0] < c:
                continue
            chosen.append(int(c))
        elim = np.array(chosen, dtype=np.int32)
        parents = np.full(elim.size, -1, dtype=np.int32)
        pair_ids = np.full(elim.size, -1, dtype=np.int32)
        for i, c in enumerate(elim):
            nbrs = [n for n in adj[c] if alive[n]]
            if nbrs:
                parents[i] = nbrs[0]
                pair_ids[i] = adj[c][nbrs[0]]
        rounds.append((elim, parents, pair_ids))
        for i, c in enumerate(elim):
            alive[c] = False
            if parents[i] >= 0:
                degree[parents[i]] -= 1
        remaining -= elim.size

    core_nodes = np.flatnonzero(alive).astype(np.int32)
    core_pairs = np.empty((0, 3), np.int32)
    if core_nodes.size:
        # Fill-in-free peeling never creates new node–node couplings, so
        # the core's off-diagonals are exactly the original pairs with
        # both endpoints alive.
        in_core = np.zeros(B, dtype=bool)
        in_core[core_nodes] = True
        core_rank = np.full(B, -1, np.int64)
        core_rank[core_nodes] = np.arange(core_nodes.size)
        sel = in_core[pairs[:, 0]] & in_core[pairs[:, 1]]
        pid = np.flatnonzero(sel)
        core_pairs = np.stack(
            [core_rank[pairs[sel, 0]], core_rank[pairs[sel, 1]], pid], axis=1
        ).astype(np.int32)
    return _TreePlan(pairs, edge_pair, tuple(rounds), core_nodes, core_pairs)


def attach_core_plan(
    tree_plan: _TreePlan,
    dense_cutoff: int = 384,
    max_core: int = 300_000,
    tail_stop: bool = True,
) -> _TreePlan:
    """Attach a sparse core-elimination plan when the cycle core admits one.

    The symbolic minimum-degree phase (``ops/core_elim.py``) costs host
    time proportional to core size + fill, so it is opt-in per call site
    rather than part of :func:`_plan_tree_elimination`.  Returns the plan
    unchanged when the core is empty, too large for the symbolic budget,
    or the fill budget is exceeded (callers then keep dense/CG behaviour).
    """
    if tree_plan.core_plan is not None or tree_plan.core_size == 0:
        return tree_plan
    if tree_plan.core_size > max_core:
        return tree_plan
    from .ops.core_elim import plan_core_elimination

    cp = None
    # Tree-multifrontal first for large cores (ops/multifrontal.py): the
    # batched-front engine replaces both the min-degree rounds (gather
    # bound at scale) and the chain-front supernodal tail for any core
    # with usable separators; refusal falls through to the rounds-based
    # planners below.  NXFX_NO_MF=1 disables (debug escape hatch).
    if tree_plan.core_size > 2048 and os.environ.get("NXFX_NO_MF") != "1":
        from .ops.multifrontal import plan_multifrontal

        cp = plan_multifrontal(
            np.asarray(tree_plan.core_pairs), tree_plan.core_size
        )
    if cp is None and tree_plan.core_size <= 65_536:
        cp = plan_core_elimination(
            tree_plan.core_pairs,
            tree_plan.core_size,
            dense_cutoff=dense_cutoff,
            tail_stop=tail_stop,
        )
    # Cores beyond ~64k never fit greedy min-degree's fill budget
    # (measured: it plans lattices only to ~128²), so skip straight to
    # the nested-dissection order there rather than paying its symbolic
    # scan twice.
    if cp is None and tree_plan.core_size > 4096:
        # Greedy min-degree blew its fill budget — the canonical case is a
        # large lattice-like core (where MUMPS would switch to METIS ND).
        # Retry with a nested-dissection elimination order, which bounds
        # fill near the O(n log n) ND asymptotic; kcap is wider because
        # separator-adjacent eliminations carry bigger cliques.
        from .ops.core_elim import nested_dissection_order

        nd = nested_dissection_order(
            np.asarray(tree_plan.core_pairs), tree_plan.core_size, leaf=8
        )
        nd_kwargs = dict(
            # top separators stall as wide cliques under ANY order — an
            # ≤8k dense frontal tail is one dense factorization (the multifrontal
            # analog), and stopping there minimises device round count;
            # beyond 8k the stalled remainder is eliminated as true
            # multifrontal supernodal fronts (512²+ per-edge-R lattices)
            dense_cutoff=8192,
            kcap=64,
            tail_stop=tail_stop,
            order=nd,
            dense_cap=8192,
            supernodal_tail=True,
        )
        cp = plan_core_elimination(
            tree_plan.core_pairs, tree_plan.core_size, **nd_kwargs
        )
        if cp is None:
            # The front-stop can hand the fronts a remainder whose
            # boundary outgrows front_cap; retry crawling the rounds all
            # the way down before conceding to the dense/CG fallback.
            cp = plan_core_elimination(
                tree_plan.core_pairs,
                tree_plan.core_size,
                front_stop=False,
                **nd_kwargs,
            )
    if cp is None:
        return tree_plan
    return tree_plan._replace(core_plan=cp)


class _LevelPlan(typing.NamedTuple):
    """Scatter-free elimination plan for FOREST bifurcation graphs.

    Bifurcations are internally permuted into root-down level order, each
    level grouped by parent.  Elimination then runs deepest-level-first:
    every per-level read is a contiguous dynamic slice, parent updates are
    full-level sorted segment-sums placed back with dynamic_update_slice,
    and the only gathers are parent lookups — no arbitrary-index scatter
    remains."""

    perm: np.ndarray  # (B,) original bif index -> permuted position
    inv_perm: np.ndarray  # (B,) permuted position -> original bif index
    level_offsets: np.ndarray  # (L+1,) slice bounds per depth level
    parent_pos: np.ndarray  # (B,) permuted parent position (-1 for roots)
    parent_pair: np.ndarray  # (B,) pair id to parent (-1 for roots)
    # λ-system assembly (full-width sorted segment-sums in permuted order)
    t_sel: np.ndarray
    t_seg: np.ndarray
    s_sel: np.ndarray
    s_seg: np.ndarray
    # sorted edge→pair aggregation for the pair conductances
    p_sel: np.ndarray
    p_seg: np.ndarray
    num_pairs: int


def _plan_level_elimination(
    asm: _assembly.HydraulicNetworkAssembler, tree_plan: _TreePlan
) -> _LevelPlan | None:
    """Build the level plan; None when the bifurcation graph has cycles."""
    if tree_plan.core_size > 0:
        return None
    mesh = asm.network
    B = mesh.num_multipliers
    pairs = tree_plan.pair_nodes
    P = pairs.shape[0]

    # Vectorized frontier BFS (one numpy pass per depth level): symmetric
    # half-edge arrays (src, dst, pair id) both ways.
    if P > 0:
        src = np.concatenate([pairs[:, 0], pairs[:, 1]])
        dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
        pid2 = np.concatenate([np.arange(P), np.arange(P)])
        order_by_src = np.argsort(src, kind="stable")
        src_s, dst_s, pid_s = src[order_by_src], dst[order_by_src], pid2[order_by_src]
        starts = np.searchsorted(src_s, np.arange(B + 1))
    else:
        dst_s = pid_s = np.empty(0, np.int64)
        starts = np.zeros(B + 1, np.int64)

    depth = np.full(B, -1, np.int64)
    parent = np.full(B, -1, np.int64)
    parent_pairid = np.full(B, -1, np.int64)
    unvisited = np.ones(B, dtype=bool)
    # roots: every component's minimum-id node (isolated bifurcations are
    # their own single-node components).  Components via scipy's
    # connected_components on the pair graph.
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import connected_components as _cc

    if P > 0:
        adjm = _sp.coo_matrix(
            (np.ones(P), (pairs[:, 0], pairs[:, 1])), shape=(B, B)
        )
        _, labels = _cc(adjm, directed=False)
    else:
        labels = np.arange(B)
    # root of each component = first occurrence (min id)
    _, first_idx = np.unique(labels, return_index=True)
    roots = np.sort(first_idx)
    depth[roots] = 0
    unvisited[roots] = False
    frontier = roots
    d = 0
    while frontier.size:
        # expand all half-edges leaving the frontier (ragged-range gather)
        counts = starts[frontier + 1] - starts[frontier]
        total = int(counts.sum())
        if total:
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            idx = np.repeat(starts[frontier] - offsets, counts) + np.arange(total)
            cand_dst = dst_s[idx]
            cand_pid = pid_s[idx]
            cand_src = np.repeat(frontier, counts)
            new_mask = unvisited[cand_dst]
            nd, npid, nsrc = cand_dst[new_mask], cand_pid[new_mask], cand_src[new_mask]
            # dedupe (a node can only be discovered once in a tree, but be safe)
            uniq, ui = np.unique(nd, return_index=True)
            depth[uniq] = d + 1
            parent[uniq] = nsrc[ui]
            parent_pairid[uniq] = npid[ui]
            unvisited[uniq] = False
            frontier = uniq
        else:
            frontier = np.empty(0, np.int64)
        d += 1

    # permute: levels ascending; within a level group by (already-assigned)
    # parent position so per-level parent segment ids come out sorted.
    max_depth = int(depth.max())
    perm = np.empty(B, np.int64)
    pos = 0
    level_offsets = [0]
    prev_positions = np.full(B, -1, np.int64)
    for d in range(max_depth + 1):
        nodes = np.flatnonzero(depth == d)
        if d > 0:
            nodes = nodes[np.argsort(prev_positions[parent[nodes]], kind="stable")]
        perm[nodes] = pos + np.arange(nodes.size)
        prev_positions[nodes] = perm[nodes]
        pos += nodes.size
        level_offsets.append(pos)

    inv_perm = np.argsort(perm)
    parent_pos = np.full(B, -1, np.int64)
    has_parent = parent >= 0
    parent_pos[perm[has_parent.nonzero()[0]]] = perm[parent[has_parent]]
    parent_pair = np.full(B, -1, np.int64)
    parent_pair[perm[has_parent.nonzero()[0]]] = parent_pairid[has_parent]

    def side(bif: np.ndarray):
        sel = np.flatnonzero(bif >= 0)
        key = perm[bif[sel]]
        order_ = sel[np.argsort(key, kind="stable")]
        return order_.astype(np.int32), np.sort(key).astype(np.int32)

    t_sel, t_seg = side(asm._edge_end_bif)
    s_sel, s_seg = side(asm._edge_start_bif)
    ep = tree_plan.edge_pair
    p_sel = np.flatnonzero(ep >= 0)
    p_order = p_sel[np.argsort(ep[p_sel], kind="stable")]
    return _LevelPlan(
        perm=perm.astype(np.int32),
        inv_perm=inv_perm.astype(np.int32),
        level_offsets=np.asarray(level_offsets, np.int64),
        parent_pos=parent_pos.astype(np.int32),
        parent_pair=parent_pair.astype(np.int32),
        t_sel=t_sel,
        t_seg=t_seg,
        s_sel=s_sel,
        s_seg=s_seg,
        p_sel=p_order.astype(np.int32),
        p_seg=np.sort(ep[p_sel]).astype(np.int32),
        num_pairs=P,
    )


def _match_slice(sub: np.ndarray) -> int | None:
    """``sub == c + arange(n)`` → ``c``; else None."""
    if sub.size and np.array_equal(sub, sub[0] + np.arange(sub.size)):
        return int(sub[0])
    return None


def _match_repeat(sub: np.ndarray) -> tuple[int, int, int, int] | None:
    """``sub == c + (arange(n) + o) // K`` → ``(c, K, o, m)`` with
    ``m = sub[-1] - sub[0] + 1`` table rows covered; else None."""
    n = sub.size
    if n == 0:
        return None
    d = np.diff(sub)
    if d.size == 0 or not np.all((d == 0) | (d == 1)):
        return None
    # run lengths of equal consecutive values
    bounds = np.concatenate([[0], np.flatnonzero(d) + 1, [n]])
    rl = np.diff(bounds)
    K = int(rl.max())
    if K <= 1:
        return None
    o = K - int(rl[0])
    if np.array_equal(sub, sub[0] + (np.arange(n) + o) // K):
        return int(sub[0]), K, o, int(sub[-1] - sub[0] + 1)
    return None


def _match_stride(sub: np.ndarray) -> tuple[int, int] | None:
    """``sub == c + s * arange(n)`` with s >= 2 → ``(c, s)``; else None."""
    if sub.size < 2:
        return None
    d = np.diff(sub)
    s = int(d[0])
    if s >= 2 and np.all(d == s):
        return int(sub[0]), s
    return None


def _structured_take(vec: jnp.ndarray, idx: np.ndarray, max_pieces: int = 6):
    """``vec[idx]`` (with ``idx < 0`` → 0) WITHOUT a device gather when the
    host-static index array is structured, else None.

    A gather is much slower than a slice (by how much is not measured on the H100), so the
    graph-structured index maps
    (identity/BFS tree numbering: slices and uniform-fanout repeats) are
    pattern-matched on the host at trace time and emitted as static slices
    / broadcast-reshapes.  Falls back (returns None) for irregular maps.
    """
    idx = np.asarray(idx)
    n = idx.size
    if n == 0:
        return jnp.zeros((0,) + vec.shape[1:], dtype=vec.dtype)
    valid = idx >= 0
    # maximal runs of constant validity
    change = np.flatnonzero(np.diff(valid.view(np.int8)))
    bounds = np.concatenate([[0], change + 1, [n]])
    if len(bounds) - 1 > max_pieces:
        return None
    tail_shape = vec.shape[1:]
    pieces = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        a, b = int(a), int(b)
        if not valid[a]:
            pieces.append(jnp.zeros((b - a,) + tail_shape, dtype=vec.dtype))
            continue
        sub = idx[a:b]
        c = _match_slice(sub)
        if c is not None:
            pieces.append(jax.lax.slice_in_dim(vec, c, c + (b - a), axis=0))
            continue
        rep = _match_repeat(sub)
        if rep is not None:
            c, K, o, m = rep
            window = jax.lax.slice_in_dim(vec, c, c + m, axis=0)
            expanded = jnp.broadcast_to(
                window[:, None], (m, K) + tail_shape
            ).reshape((m * K,) + tail_shape)
            pieces.append(jax.lax.slice_in_dim(expanded, o, o + (b - a), axis=0))
            continue
        st = _match_stride(sub)
        if st is None:
            return None
        c, s = st
        pieces.append(
            jax.lax.slice_in_dim(vec, c, c + s * (b - a - 1) + 1, stride=s, axis=0)
        )
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=0)


def _segsum_sorted(
    vals: jnp.ndarray,
    seg_sorted: np.ndarray,
    num_segments: int,
    max_fold_width: int = 32,
    sel: np.ndarray | None = None,
):
    """Sorted-segment sum with static (host-known) segment ids.

    Lowering note: ``jax.ops.segment_sum`` becomes an XLA scatter-add
    (atomic on GPUs, so its f64 summation order may vary from run to run;
    the fold below is fixed-order).  Since the segment ids are host-static
    and network segments are tiny (a bifurcation has a handful of incident
    edges, a tree parent a couple of children), the reduction is instead
    folded through a host-precomputed ``(num_segments, K)`` gather
    matrix.  Exact f64 (only the within-segment addition order changes).  Falls back to segment_sum for pathological K (a hub
    node with thousands of incident edges).

    A cumsum+boundary-difference formulation would also vectorize but
    loses ~eps * (prefix magnitude / segment magnitude) of relative
    accuracy — with the 4-orders-of-magnitude conductance spread of deep
    arterial trees that breached the 1e-8 solution contract, so exact
    per-segment reductions are required.

    ``vals`` may be (n,) or multi-channel (n, C) — channels sharing one
    segment layout reduce through a single gather (one kernel instead of
    C).

    ``sel`` (host-static) composes a pre-selection ``vals[sel]`` into the
    fold's gather matrix, so selection + reduction cost ONE device gather
    instead of two.  When the composed index map is contiguous with
    uniform segment width (graph-generator numbering produces exactly
    this), the whole fold lowers to a static slice + reshape + row-sum —
    no gather at all (same elements, same addition order: exact).
    """
    seg_np = np.asarray(seg_sorted)
    n_in = seg_np.shape[0]
    out_shape = (num_segments,) + vals.shape[1:]
    if n_in == 0:
        return jnp.zeros(out_shape, dtype=vals.dtype)
    if num_segments > 0:
        counts = np.bincount(seg_np, minlength=num_segments)
        K = int(counts.max())
        if 0 < K <= max_fold_width:
            offsets = np.concatenate([[0], np.cumsum(counts)])
            idx = offsets[:-1, None] + np.arange(K)[None, :]
            valid = np.arange(K)[None, :] < counts[:, None]
            if sel is not None:
                sel = np.asarray(sel)
                idx = np.where(valid, sel[np.minimum(idx, n_in - 1)], vals.shape[0])
            else:
                idx = np.where(valid, idx, vals.shape[0])  # pad slot
            if bool(valid.all()):
                c = _match_slice(idx.ravel())
                if c is not None:
                    window = jax.lax.slice_in_dim(
                        vals, c, c + num_segments * K, axis=0
                    )
                    return jnp.sum(
                        window.reshape((num_segments, K) + vals.shape[1:]), axis=1
                    )
            pad = jnp.zeros((1,) + vals.shape[1:], dtype=vals.dtype)
            vp = jnp.concatenate([vals, pad])
            return jnp.sum(vp[jnp.asarray(idx)], axis=1)
    if sel is not None:
        vals = vals[jnp.asarray(sel)]
    return jax.ops.segment_sum(
        vals, jnp.asarray(seg_np), num_segments=num_segments,
        indices_are_sorted=True,
    )


def _level_eliminate(
    lp: _LevelPlan, ed: _EdgeData, B: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter-free forward elimination + back-substitution; returns
    (λ in the ORIGINAL bifurcation ordering, ‖rhs‖)."""
    dt = ed.W.dtype
    w_edges = 1.0 / ed.W
    if lp.num_pairs > 0:
        w_pairs = _segsum_sorted(w_edges, lp.p_seg, lp.num_pairs, sel=lp.p_sel)
    else:
        w_pairs = jnp.zeros(0, dtype=dt)
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    const = (-ed.start_pbc * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
    Ftot = ed.cumF[:, -1]

    # permuted-order diag/rhs: the (w, rhs) channels share each side's
    # segment layout, so both reduce through ONE two-channel fold with the
    # selection composed in (slice/reshape when the layout is structured)
    def full_reduce2(vals2, sel, seg):
        return _segsum_sorted(vals2, seg, B, sel=sel)

    dt_t = full_reduce2(jnp.stack([w_edges, const + Ftot], axis=-1), lp.t_sel, lp.t_seg)
    dt_s = full_reduce2(jnp.stack([w_edges, -const], axis=-1), lp.s_sel, lp.s_seg)
    dr = dt_t + dt_s  # (B, 2): fused (diag, rhs) channels
    rhs_norm = jnp.linalg.norm(dr[:, 1])
    return _level_eliminate_core2(lp, dr, w_pairs, B), rhs_norm


def _level_eliminate_core(
    lp: _LevelPlan,
    d: jnp.ndarray,
    r: jnp.ndarray,
    w_pairs: jnp.ndarray,
    B: int,
) -> jnp.ndarray:
    """Level-ordered elimination given (diag, rhs) already in PERMUTED
    order; returns λ in the ORIGINAL ordering.  Used with psum-reduced
    replicated inputs by the sharded path."""
    return _level_eliminate_core2(lp, jnp.stack([d, r], axis=-1), w_pairs, B)


def _level_eliminate_core2(
    lp: _LevelPlan,
    dr: jnp.ndarray,
    w_pairs: jnp.ndarray,
    B: int,
) -> jnp.ndarray:
    """Level elimination on the fused (B, 2) = (diag, rhs) array.

    Keeping both channels in one array halves the per-level kernel count
    (one dynamic slice + one update instead of two of each) — the upper
    tree levels are a handful of nodes each, so their cost is pure launch
    latency and scales with kernels, not elements."""
    dt = dr.dtype
    # per-node parent conductance (0 for roots; host-static map — a BFS
    # numbering makes it a shifted identity, so no gather)
    if w_pairs.shape[0]:
        w_node = _structured_take(w_pairs, lp.parent_pair)
        if w_node is None:
            pp = jnp.asarray(lp.parent_pair)
            w_node = jnp.where(pp >= 0, w_pairs[jnp.where(pp >= 0, pp, 0)], 0.0)
    else:
        w_node = jnp.zeros(B, dt)
    offs = lp.level_offsets
    L = len(offs) - 1
    # Per-level arrays instead of one carried (B, 2) buffer: updating a
    # carried array with dynamic_update_slice forces XLA to COPY the whole
    # buffer every level (O(B·L) traffic and two extra kernels per level,
    # measured as ~1/3 of the λ-stage device time); per-level pieces make
    # the parent update a plain fused add with no slice/update/copy at all.
    dr_lev = [
        jax.lax.slice_in_dim(dr, int(offs[lev]), int(offs[lev + 1]), axis=0)
        for lev in range(L)
    ]
    w_lev = [
        jax.lax.slice_in_dim(w_node, int(offs[lev]), int(offs[lev + 1]), axis=0)
        for lev in range(L)
    ]
    saved = []
    # forward: deepest level first
    for lev in range(L - 1, 0, -1):
        o, o1, op, op1 = int(offs[lev]), int(offs[lev + 1]), int(offs[lev - 1]), int(offs[lev])
        npar = op1 - op
        blk = dr_lev[lev]
        db, rb = blk[:, 0], blk[:, 1]
        w = w_lev[lev]
        seg_host = lp.parent_pos[o:o1] - op  # sorted by construction
        factor = w / db
        upd = _segsum_sorted(
            jnp.stack([-w * factor, factor * rb], axis=-1), seg_host, npar
        )
        dr_lev[lev - 1] = dr_lev[lev - 1] + upd
        saved.append((lev, o, db, rb, w))

    # roots (level 0): no parents
    blk0 = dr_lev[0]
    lam_lev: list = [None] * L
    lam_lev[0] = blk0[:, 1] / blk0[:, 0]
    # back-substitution: root-down (parent lookups are host-static per
    # level — structured maps become slices/broadcasts, not gathers)
    for lev, o, db, rb, w in reversed(saved):
        o1 = int(offs[lev + 1])
        par_local = lp.parent_pos[o:o1] - int(offs[lev - 1])
        lam_par = _structured_take(lam_lev[lev - 1], par_local)
        if lam_par is None:
            lam_par = lam_lev[lev - 1][jnp.asarray(par_local)]
        lam_lev[lev] = (rb + w * lam_par) / db
    lam = lam_lev[0] if L == 1 else jnp.concatenate(lam_lev)
    unperm = _structured_take(lam, lp.perm)
    return unperm if unperm is not None else lam[jnp.asarray(lp.perm)]


# ======================================================================
# Blocked-sibling fast path (uniformly-binary forests, k=1, uniform coeffs)
# ======================================================================


class _BlockedLevel(typing.NamedTuple):
    """One level of the blocked-sibling layout (all values host-static).

    ``in_parts`` are the internal-edge slices holding this level's in-edges
    (widths summing to ``m``, ordered to match the level's bifurcation
    order); ``outs`` is one ``(edge_offset, targets_bif)`` entry per
    out-edge slot — every bifurcation of the level has the same out-degree
    ``len(outs)`` and slot ``j`` of all of them forms one contiguous
    ``m``-wide block."""

    m: int  # number of bifurcations at this level
    in_parts: tuple  # ((start, width), ...) in-edge slices
    outs: tuple  # ((start, targets_bif), ...) per out slot, each m wide

    @property
    def n_bif_outs(self) -> int:
        return sum(1 for _, b in self.outs if b)


class _BlockedPlan(typing.NamedTuple):
    """Interleave-free elimination layout for uniformly-binary forests.

    Within-row element reordering — adjacent-pair folds, K=2 repeats — was
    the costly part of the general executor on the hardware this was tuned
    on, while contiguous slices, whole-array adds, broadcasts and concats
    were ~free (not measured on the H100).  This plan renumbers
    bifurcations level-major with, per level, all first-siblings before
    all second-siblings, and edges as [root in-edges][per level: out1
    block, out2 block].  Every step of assembly, elimination,
    back-substitution and the λ→edge expansion then lowers to contiguous
    slices/adds/concats — no interleave anywhere on device.  The
    public↔internal permutation is applied host-side (args in
    ``prepare_args``, outputs in the flatten).

    Applies when every bifurcation has exactly one in-edge, all
    bifurcations of a level share one out-degree K (K may vary BETWEEN
    levels), and each sibling block's targets are uniformly bifurcations
    or uniformly boundary leaves (true for ``make_tree``,
    ``make_arterial_tree`` and any uniformly-K-ary forest; anything else
    falls back to the general level plan).
    """

    bif_order: np.ndarray  # (B_sub,) internal position -> public bif index
    edge_order: np.ndarray  # (E_sub,) internal position -> public edge id
    n_roots: int  # root in-edges occupy internal positions [0, n_roots)
    levels: tuple  # tuple[_BlockedLevel]
    bif_offsets: np.ndarray  # (L+1,) internal bif slice bounds per level
    s_is_bif: np.ndarray  # (E_sub,) internal order: edge source is a bif
    t_is_bif: np.ndarray  # (E_sub,) internal order: edge target is a bif


def _blocked_walk(
    roots: np.ndarray,
    in_edge: np.ndarray,
    out_data: np.ndarray,
    out_offs: np.ndarray,
    out_counts: np.ndarray,
    tgt_bif: np.ndarray,
):
    """Level-major sibling-blocked BFS from ``roots``; returns
    ``(bif_order, edge_order, levels, bif_offsets)`` or None when a level
    breaks the uniformity conditions (mixed out-degree or mixed sub-block
    targets).  Shared by the serial plan (roots = boundary-fed bifs) and
    the sharded plan (roots = a device's chunk roots)."""
    bif_order_parts = [roots]
    edge_order_parts = [in_edge[roots]]
    levels: list[_BlockedLevel] = []
    offsets = [0, roots.size]
    epos = roots.size  # next free internal edge position
    cur = roots
    in_parts: tuple = ((0, int(roots.size)),)
    while cur.size:
        m = cur.size
        K_arr = out_counts[cur]
        K = int(K_arr[0])
        if not np.all(K_arr == K) or K == 0:
            return None  # mixed out-degree within a level
        out_e = out_data[out_offs[cur][:, None] + np.arange(K)[None, :]]  # (m, K)
        outs = []
        nxt_parts = []
        next_in_parts = []
        for j in range(K):
            ej = out_e[:, j]
            tj = tgt_bif[ej]
            sub_bif = bool(np.all(tj >= 0))
            if not sub_bif and np.any(tj >= 0):
                return None  # mixed targets within a sibling block
            outs.append((epos + j * m, sub_bif))
            edge_order_parts.append(ej)
            if sub_bif:
                nxt_parts.append(tj)
                next_in_parts.append((epos + j * m, m))
        levels.append(_BlockedLevel(m=m, in_parts=in_parts, outs=tuple(outs)))
        epos += K * m
        in_parts = tuple(next_in_parts)
        nxt = np.concatenate(nxt_parts) if nxt_parts else np.empty(0, np.int64)
        if nxt.size:
            bif_order_parts.append(nxt)
            offsets.append(offsets[-1] + nxt.size)
        cur = nxt
    return (
        np.concatenate(bif_order_parts),
        np.concatenate(edge_order_parts).astype(np.int64),
        tuple(levels),
        np.asarray(offsets, dtype=np.int64),
    )


def _blocked_csr(asm: _assembly.HydraulicNetworkAssembler):
    """Host CSR arrays for the blocked walk, or None when some bifurcation
    has in-degree != 1."""
    mesh = asm.network
    in_data, in_offs = mesh.bif_in_csr
    out_data, out_offs = mesh.bif_out_csr
    if not np.all(np.diff(in_offs) == 1):
        return None
    return (
        np.asarray(in_data, dtype=np.int64),
        np.asarray(out_data, dtype=np.int64),
        np.asarray(out_offs[:-1], dtype=np.int64),
        np.diff(out_offs).astype(np.int64),
    )


def _plan_blocked(asm: _assembly.HydraulicNetworkAssembler) -> _BlockedPlan | None:
    """Build the blocked-sibling plan, or None when the topology is not a
    uniformly-K-ary forest."""
    mesh = asm.network
    B = mesh.num_multipliers
    E = mesh.num_edges
    if B == 0:
        return None
    csr = _blocked_csr(asm)
    if csr is None:
        return None
    in_edge, out_data, out_offs, out_counts = csr
    src_bif = np.asarray(asm._edge_start_bif)  # (E,) -1 for boundary source
    tgt_bif = np.asarray(asm._edge_end_bif)

    roots = np.flatnonzero(src_bif[in_edge] < 0)  # bifs fed from a boundary
    if roots.size == 0:
        return None
    roots = np.sort(roots)
    walk = _blocked_walk(roots, in_edge, out_data, out_offs, out_counts, tgt_bif)
    if walk is None:
        return None
    bif_order, edge_order, levels, offsets = walk
    if bif_order.size != B or np.unique(bif_order).size != B:
        return None  # disconnected bifs (e.g. a separate cycle) — fall back
    if edge_order.size != E or np.unique(edge_order).size != E:
        return None  # uncovered edges (boundary-to-boundary segments)
    if len(levels) > 512:
        # deep chain-like topologies would unroll one slice/add group per
        # level into the traced program — compile blowup for no win
        return None
    return _BlockedPlan(
        bif_order=bif_order,
        edge_order=edge_order,
        n_roots=int(roots.size),
        levels=levels,
        bif_offsets=offsets,
        s_is_bif=src_bif[edge_order] >= 0,
        t_is_bif=tgt_bif[edge_order] >= 0,
    )


def _parts_concat(vec, parts):
    ps = [jax.lax.slice_in_dim(vec, s, s + width) for s, width in parts]
    return ps[0] if len(ps) == 1 else jnp.concatenate(ps)


def _blocked_forward_factor(plan: _BlockedPlan, w: jnp.ndarray):
    """R-side (coefficient-matrix) half of the forward elimination.

    Returns ``(d_lev, wn_lev, factor_lev)`` — the eliminated per-level
    diagonals, the in-edge (parent-coupling) conductances, and the
    per-level elimination factors wn/d.  Depends on the resistance data
    only: this is the reusable "factorization" (the MUMPS-factor analog,
    reference ``solver.py:58-65`` — KSP reuses the factor across solves)
    consumed by :func:`_blocked_forward_apply` for each right-hand side."""
    L = len(plan.levels)
    d_lev: list = [None] * L
    wn_lev: list = [None] * L
    for l, lv in enumerate(plan.levels):
        w_in = _parts_concat(w, lv.in_parts)
        d = w_in
        for o, _ in lv.outs:
            d = d + jax.lax.slice_in_dim(w, o, o + lv.m)
        d_lev[l], wn_lev[l] = d, w_in
    factor_lev: list = [None] * L
    for l in range(L - 1, 0, -1):
        lv_par = plan.levels[l - 1]
        m_par = lv_par.m
        wn = wn_lev[l]
        factor = wn / d_lev[l]
        cd = -wn * factor
        upd_d = cd[:m_par]
        for j in range(1, lv_par.n_bif_outs):
            upd_d = upd_d + cd[j * m_par : (j + 1) * m_par]
        d_lev[l - 1] = d_lev[l - 1] + upd_d
        factor_lev[l] = factor
    return d_lev, wn_lev, factor_lev


def _blocked_forward_apply(
    plan: _BlockedPlan,
    d_lev: list,
    wn_lev: list,
    factor_lev: list,
    const: jnp.ndarray,
    Ftot: jnp.ndarray,
):
    """Rhs half of the forward elimination against a cached factor."""
    L = len(plan.levels)
    r_lev: list = [None] * L
    cF = const + Ftot
    for l, lv in enumerate(plan.levels):
        r = _parts_concat(cF, lv.in_parts)
        for o, _ in lv.outs:
            r = r - jax.lax.slice_in_dim(const, o, o + lv.m)
        r_lev[l] = r
    rhs_sq = sum(jnp.sum(r * r) for r in r_lev)
    saved: list = [None] * L
    for l in range(L - 1, 0, -1):
        lv_par = plan.levels[l - 1]
        m_par = lv_par.m
        cr = factor_lev[l] * r_lev[l]
        upd_r = cr[:m_par]
        for j in range(1, lv_par.n_bif_outs):
            upd_r = upd_r + cr[j * m_par : (j + 1) * m_par]
        r_lev[l - 1] = r_lev[l - 1] + upd_r
        saved[l] = (d_lev[l], r_lev[l], wn_lev[l])
    return d_lev[0], r_lev[0], wn_lev[0], saved, rhs_sq


def _blocked_forward(
    plan: _BlockedPlan,
    w: jnp.ndarray,  # (>=E_sub,) 1/W in INTERNAL edge order
    const: jnp.ndarray,  # (>=E_sub,) boundary/source constant, internal order
    Ftot: jnp.ndarray,  # (>=E_sub,) total source flux per edge, internal order
):
    """Assembly + forward elimination, every step a contiguous
    slice/add/concat.  Returns ``(d0, r0, w0, saved, rhs_sq)`` — the
    root-level system, the in-edge (parent-coupling) conductances of the
    roots, and the per-level state for :func:`_blocked_backward`.  Shared
    by the serial eliminate (roots close against the boundary) and the
    sharded one (roots eliminate into the psum-reduced top system).
    Internally split into the R-side factor and the rhs apply so
    factor-reuse serving (:func:`build_blocked_factorization`) shares the
    exact same formulas."""
    d_lev, wn_lev, factor_lev = _blocked_forward_factor(plan, w)
    return _blocked_forward_apply(plan, d_lev, wn_lev, factor_lev, const, Ftot)


def _blocked_backward(plan: _BlockedPlan, saved: list, lam0: jnp.ndarray):
    """Back-substitution given the root-level λ: parents' λ block-tiles
    down to children (one tile per bif-targeting out slot)."""
    L = len(plan.levels)
    lam_lev: list = [None] * L
    lam_lev[0] = lam0
    for l in range(1, L):
        lv_par = plan.levels[l - 1]
        nb = lv_par.n_bif_outs
        lp_ = lam_lev[l - 1]
        lam_par = lp_ if nb == 1 else jnp.concatenate([lp_] * nb)
        db, rb, wn = saved[l]
        lam_lev[l] = (rb + wn * lam_par) / db
    lam = lam_lev[0] if L == 1 else jnp.concatenate(lam_lev)
    return lam_lev, lam


def _blocked_eliminate(
    plan: _BlockedPlan,
    w: jnp.ndarray,
    const: jnp.ndarray,
    Ftot: jnp.ndarray,
):
    """λ elimination with every step a contiguous slice/add/concat.

    Returns (lam_levels, lam (B,) internal order, rhs_norm)."""
    d0, r0, _, saved, rhs_sq = _blocked_forward(plan, w, const, Ftot)
    lam_lev, lam = _blocked_backward(plan, saved, r0 / d0)
    return lam_lev, lam, jnp.sqrt(rhs_sq)


def _blocked_eliminate_scan(
    plan: _BlockedPlan,
    w: jnp.ndarray,
    const: jnp.ndarray,
    Ftot: jnp.ndarray,
    m_cut: int = 1024,
):
    """λ elimination with the SHALLOW levels under ``lax.scan``.

    The unrolled elimination emits a few tiny kernels per level; at 16
    generations the ≤1024-wide levels carry only ~2k elements through
    ~dozens of launch-bound kernels (the measured serving tail — STATUS
    round-3 roofline: the device program is dispatch-, not
    bandwidth-bound).  Here those levels run as two scans (forward, and a
    reverse scan for back-substitution) over a padded uniform width M =
    the widest shallow level: every step reads fixed-size dynamic slices
    of the flat edge arrays directly, so no stacked relayout pass is
    needed, and the whole shallow tail becomes a handful of fused loop
    kernels.  Deep levels keep the unrolled full-width program (they are
    bandwidth-bound and already efficient).

    Numerically equivalent to :func:`_blocked_eliminate` (same folds in
    the same order, padded lanes carry zeros); pinned by
    ``tests/test_blocked.py::test_blocked_level_scan_matches_unrolled``.
    Opt-in via ``SolverOptions(level_scan="on")`` until profiled faster
    on the target chip.
    """
    L = len(plan.levels)
    levels = plan.levels
    # shallow prefix: levels with m <= m_cut whose in_parts are uniform
    # sibling blocks of the parent's width (true for every blocked-
    # eligible forest); anything else keeps the unrolled path.
    t = 0
    while t < L and levels[t].m <= m_cut:
        if t > 0:
            mp = levels[t - 1].m
            parts = levels[t].in_parts
            if any(wd != mp for _, wd in parts) or len(parts) * mp != levels[t].m:
                break
        t += 1
    if t < 3:
        return _blocked_eliminate(plan, w, const, Ftot)

    dt = w.dtype
    M = int(levels[t - 1].m)
    KI = max(len(lv.in_parts) for lv in levels[1:t])
    KO = max((len(lv.outs) for lv in levels[1:t]), default=1) or 1
    cF = const + Ftot
    zpad = jnp.zeros(M, dt)
    w_ext = jnp.concatenate([w, zpad])
    cF_ext = jnp.concatenate([cF, zpad])
    c_ext = jnp.concatenate([const, zpad])
    iota = jnp.arange(M)

    # ---------- deep levels: unrolled assembly + recursion down to t
    d_lev: list = [None] * L
    wn_lev: list = [None] * L
    r_lev: list = [None] * L
    for l in range(t, L):
        lv = levels[l]
        d = _parts_concat(w, lv.in_parts)
        wn_lev[l] = d
        r = _parts_concat(cF, lv.in_parts)
        for o, _tb in lv.outs:
            d = d + jax.lax.slice_in_dim(w, o, o + lv.m)
            r = r - jax.lax.slice_in_dim(const, o, o + lv.m)
        d_lev[l], r_lev[l] = d, r
    rhs_sq = sum(
        (jnp.sum(r * r) for r in r_lev[t:]), jnp.zeros((), dt)
    )
    saved_deep: list = [None] * L
    upd_d = upd_r = None
    for l in range(L - 1, t - 1, -1):
        lv_par = levels[l - 1]
        m_par = lv_par.m
        wn = wn_lev[l]
        factor = wn / d_lev[l]
        cd = -wn * factor
        cr = factor * r_lev[l]
        ud = cd[:m_par]
        ur = cr[:m_par]
        for j in range(1, lv_par.n_bif_outs):
            ud = ud + cd[j * m_par : (j + 1) * m_par]
            ur = ur + cr[j * m_par : (j + 1) * m_par]
        saved_deep[l] = (d_lev[l], r_lev[l], wn)
        if l - 1 >= t:
            d_lev[l - 1] = d_lev[l - 1] + ud
            r_lev[l - 1] = r_lev[l - 1] + ur
        else:
            upd_d = jnp.zeros(M, dt).at[:m_par].set(ud)
            upd_r = jnp.zeros(M, dt).at[:m_par].set(ur)
    if upd_d is None:  # t == L: every level is shallow
        upd_d = upd_r = jnp.zeros(M, dt)

    # ---------- scan inputs: shallow levels t-1 .. 1 (deepest first)
    lls = list(range(t - 1, 0, -1))
    n_s = len(lls)
    m_arr = np.asarray([levels[l].m for l in lls], np.int32)
    mp_arr = np.asarray([levels[l - 1].m for l in lls], np.int32)
    in_off = np.zeros((n_s, KI), np.int32)
    in_ok = np.zeros((n_s, KI), bool)
    out_off = np.zeros((n_s, KO), np.int32)
    out_ok = np.zeros((n_s, KO), bool)
    for i, l in enumerate(lls):
        for j, (s, _wd) in enumerate(levels[l].in_parts):
            in_off[i, j] = s
            in_ok[i, j] = True
        for j, (s, _tb) in enumerate(levels[l].outs):
            out_off[i, j] = s
            out_ok[i, j] = True
    xs = (
        jnp.asarray(m_arr),
        jnp.asarray(mp_arr),
        jnp.asarray(in_off),
        jnp.asarray(in_ok),
        jnp.asarray(out_off),
        jnp.asarray(out_ok),
    )

    def place_parts(vec_ext, offs, oks, mp):
        """Sibling blocks (width mp each) → one (M,) row.

        Writes run ascending j, so a later window's zero tail never
        clobbers an earlier part's valid span; invalid slots land at or
        beyond the level's width (zeros there are inert)."""
        buf = jnp.zeros(2 * M, dt)
        pm = (iota < mp).astype(dt)
        for j in range(KI):
            part = jax.lax.dynamic_slice(vec_ext, (offs[j],), (M,))
            part = part * pm * oks[j].astype(dt)
            buf = jax.lax.dynamic_update_slice(buf, part, (j * mp,))
        return buf[:M]

    def fwd_body(carry, x):
        up_d, up_r, acc = carry
        m, mp, ioff, iok, ooff, ook = x
        mask = (iota < m).astype(dt)
        w_in = place_parts(w_ext, ioff, iok, mp)
        r = place_parts(cF_ext, ioff, iok, mp)
        d = w_in
        for j in range(KO):
            okj = ook[j].astype(dt) * mask
            d = d + jax.lax.dynamic_slice(w_ext, (ooff[j],), (M,)) * okj
            r = r - jax.lax.dynamic_slice(c_ext, (ooff[j],), (M,)) * okj
        acc = acc + jnp.sum(r * r)  # pre-recursion rhs, like the unrolled path
        d = d + up_d
        r = r + up_r
        d = jnp.where(iota < m, d, 1.0)  # padded lanes stay division-safe
        factor = w_in / d
        cd_ext = jnp.concatenate([-w_in * factor, zpad])
        cr_ext = jnp.concatenate([factor * r, zpad])
        pm = (iota < mp).astype(dt)
        nd = jnp.zeros(M, dt)
        nr = jnp.zeros(M, dt)
        # fold sibling blocks into the parent (the parent's bif-targeting
        # out slots are exactly this level's in_parts, in order)
        for j in range(KI):
            okj = iok[j].astype(dt)
            nd = nd + jax.lax.dynamic_slice(cd_ext, (j * mp,), (M,)) * pm * okj
            nr = nr + jax.lax.dynamic_slice(cr_ext, (j * mp,), (M,)) * pm * okj
        return (nd, nr, acc), (d, r, w_in)

    (fin_d, fin_r, rhs_sq), ys = jax.lax.scan(
        fwd_body, (upd_d, upd_r, rhs_sq), xs
    )

    # ---------- level 0 (roots): assembled unrolled, closed by the carry
    lv0 = levels[0]
    m0 = lv0.m
    w0 = _parts_concat(w, lv0.in_parts)
    r0 = _parts_concat(cF, lv0.in_parts)
    d0 = w0
    for o, _tb in lv0.outs:
        d0 = d0 + jax.lax.slice_in_dim(w, o, o + m0)
        r0 = r0 - jax.lax.slice_in_dim(const, o, o + m0)
    rhs_sq = rhs_sq + jnp.sum(r0 * r0)
    d0 = d0 + fin_d[:m0]
    r0 = r0 + fin_r[:m0]
    lam0 = r0 / d0

    # ---------- back-substitution: reverse scan (shallowest level first)
    def bwd_body(lam_par, x_ys):
        (m, mp, ioff, iok, ooff, ook), (d, r, w_in) = x_ys
        del ioff, ooff, ook
        lp = lam_par * (iota < mp).astype(dt)
        buf = jnp.zeros(2 * M, dt)
        for j in range(KI):
            buf = jax.lax.dynamic_update_slice(buf, lp, (j * mp,))
        lam_l = (r + w_in * buf[:M]) / d  # padded lanes: 0/1 == 0
        return lam_l, lam_l

    lam_init = jnp.zeros(M, dt).at[:m0].set(lam0)
    _last, lam_rows = jax.lax.scan(bwd_body, lam_init, (xs, ys), reverse=True)

    lam_lev: list = [None] * L
    lam_lev[0] = lam0
    for i, l in enumerate(lls):
        lam_lev[l] = lam_rows[i][: levels[l].m]
    for l in range(t, L):
        lv_par = levels[l - 1]
        nb = lv_par.n_bif_outs
        lp_ = lam_lev[l - 1]
        lam_par = lp_ if nb == 1 else jnp.concatenate([lp_] * nb)
        db, rb, wn = saved_deep[l]
        lam_lev[l] = (rb + wn * lam_par) / db
    lam = lam_lev[0] if L == 1 else jnp.concatenate(lam_lev)
    return lam_lev, lam, jnp.sqrt(rhs_sq)


def _blocked_lambda_to_edges(
    plan: _BlockedPlan, lam_lev: list, dt, lam_root_src: jnp.ndarray | None = None
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-edge (lam_s, lam_t) in INTERNAL edge order — all concats/slices
    of the per-level λ pieces (the general path's repeat-expansion costs
    ~1.6 ms at 1M edges; this is free).  Non-bif endpoints carry zeros
    (masked by the caller via the plan's static masks).  ``lam_root_src``
    supplies the λ of the root in-edges' SOURCE nodes (the sharded path,
    where chunk roots hang off the replicated top tree rather than the
    boundary)."""
    zeros_root = (
        jnp.zeros(plan.n_roots, dtype=dt) if lam_root_src is None else lam_root_src
    )
    s_parts = [zeros_root]
    t_parts = [lam_lev[0]]  # root in-edges target the level-0 bifs
    for l, lv in enumerate(plan.levels):
        lam_l = lam_lev[l]
        lam_child = lam_lev[l + 1] if lv.n_bif_outs else None
        cursor = 0
        for _, is_bif in lv.outs:
            s_parts.append(lam_l)
            if is_bif:
                t_parts.append(
                    jax.lax.slice_in_dim(lam_child, cursor, cursor + lv.m)
                )
                cursor += lv.m
            else:
                t_parts.append(jnp.zeros(lv.m, dtype=dt))
    lam_s = jnp.concatenate(s_parts) if len(s_parts) > 1 else s_parts[0]
    lam_t = jnp.concatenate(t_parts) if len(t_parts) > 1 else t_parts[0]
    return lam_s, lam_t


def _blocked_condense(
    N: int,
    E: int,
    h_e: jnp.ndarray,
    R_data: jnp.ndarray,
    f_data: jnp.ndarray,
    R_mode: str,
    f_mode: str,
    k: int = 1,
):
    """Per-edge condensed quantities in the blocked internal order.

    Returns ``(W, g, Ftot, back)`` where ``back(q0, r0)`` produces the
    j-major solution blocks ``(q_T (k·N+1, E), p_T (N, E))``.  Coefficient
    modes: "scalar"/"edge" use the uniform closed forms (no (C,)-sized
    intermediate anywhere — see :func:`_make_edge_data_uniform`); "cell"
    keeps (N, E) j-major arrays whose every op is contiguous along the
    128-lane edge axis (cumsums run along the short sublane axis).

    ``k`` is the flux degree: static condensation of the interior cell
    dofs commutes with the per-cell scaling, so degree ≥ 2 only swaps the
    P1 closed-form constants for the fixed condensed ones of
    :func:`_condensed_scalar_constants` (and adds the scale-free interior
    recovery in ``back``) — the elimination itself is degree-blind.

    Internally split into :func:`_blocked_condense_R` (resistance side —
    the reusable factor half) and the source/back-substitution half here,
    so factor-reuse serving shares the exact same formulas."""
    W, a1, a2 = _blocked_condense_R(N, E, h_e, R_data, R_mode, k)
    g, Ftot, back = _blocked_condense_f(N, E, h_e, f_data, f_mode, a1, a2, k)
    return W, g, Ftot, back


def _blocked_condense_R(
    N: int, E: int, h_e: jnp.ndarray, R_data: jnp.ndarray, R_mode: str, k: int
):
    """Resistance-side condensation: ``(W, a1, a2)`` (see _blocked_condense)."""
    dt = R_data.dtype
    wt = 1.0 if k == 1 else _condensed_scalar_constants(k)[2]
    if R_mode in ("scalar", "edge"):
        a1 = (R_data[0] * jnp.ones(E, dt) if R_mode == "scalar" else R_data) * h_e
        a2 = None
        W = a1 * (N * wt)
    else:  # "cell": R_data is (N, E) j-major
        a2 = R_data * h_e[None, :]
        a1 = None
        W = wt * jnp.sum(a2, axis=0)
    return W, a1, a2


def _blocked_condense_f(
    N: int,
    E: int,
    h_e: jnp.ndarray,
    f_data: jnp.ndarray,
    f_mode: str,
    a1,
    a2,
    k: int,
):
    """Source-side condensation against cached resistance data: returns
    ``(g, Ftot, back)`` (see _blocked_condense)."""
    dt = f_data.dtype
    if k == 1:
        wt, cs0, cs1 = 1.0, 0.5, 0.5
        Mt_np = Minv_np = None
    else:
        Mt_np, csum_np, wt, Minv_np = _condensed_scalar_constants(k)
        cs0, cs1 = float(csum_np[0]), float(csum_np[1])
    if f_mode in ("scalar", "edge"):
        F1 = (f_data[0] * jnp.ones(E, dt) if f_mode == "scalar" else f_data) * h_e
        F2 = None
        Ftot = F1 * N
        cumF = None
    else:  # "cell": f_data is (N, E) j-major
        F2 = f_data * h_e[None, :]
        F1 = None
        cumF = jnp.concatenate([jnp.zeros((1, E), dt), jnp.cumsum(F2, axis=0)], axis=0)
        Ftot = cumF[-1]
    # g = 1ᵀ M cumF  (csum-weighted endpoint values of each cell;
    # Σ_c (cs0·c + cs1·(c+1)) = wt·N(N−1)/2 + cs1·N, wt = cs0 + cs1)
    if a1 is not None and F1 is not None:
        g = a1 * F1 * (wt * (N * (N - 1) / 2.0) + cs1 * N)
    else:
        if cumF is None:
            j = jnp.arange(N + 1, dtype=dt)
            cumF = F1[None, :] * j[:, None]
        wsum = cs0 * cumF[:-1] + cs1 * cumF[1:]
        g = a1 * jnp.sum(wsum, axis=0) if a2 is None else jnp.sum(a2 * wsum, axis=0)

    def back(q0: jnp.ndarray, r0: jnp.ndarray):
        if k == 1 and a1 is not None and F1 is not None:
            j = jnp.arange(N + 1, dtype=dt)
            q_T = q0[None, :] + F1[None, :] * j[:, None]
            c = jnp.arange(N, dtype=dt)
            p_T = (
                r0[None, :]
                - (a1 * q0)[None, :] * (c + 0.5)[:, None]
                - (a1 * F1)[None, :] * (c * c / 2.0 + (3.0 * c + 1.0) / 6.0)[:, None]
            )
            return q_T, p_T
        cf = cumF
        if cf is None:
            j = jnp.arange(N + 1, dtype=dt)
            cf = F1[None, :] * j[:, None]
        q_chain = q0[None, :] + cf
        qj, qj1 = q_chain[:-1], q_chain[1:]
        ab = a2 if a2 is not None else a1[None, :]
        if k == 1:
            mc0 = ab * (qj / 3.0 + qj1 / 6.0)
            mc1 = ab * (qj / 6.0 + qj1 / 3.0)
        else:
            mc0 = ab * (float(Mt_np[0, 0]) * qj + float(Mt_np[0, 1]) * qj1)
            mc1 = ab * (float(Mt_np[1, 0]) * qj + float(Mt_np[1, 1]) * qj1)
        zrow = jnp.zeros((1, E), dt)
        m_nodes = jnp.concatenate([mc0, zrow], axis=0) + jnp.concatenate(
            [zrow, mc1], axis=0
        )
        p_T = r0[None, :] - jnp.cumsum(m_nodes[:-1], axis=0)
        if k == 1:
            return q_chain, p_T
        # Interior recovery: fixed scale-free (k-1, 2) matrix (see
        # _condensed_scalar_constants); cell-major dof order matches
        # _backsub_from_lambda's (chain_j, interior_j…) layout.
        q_int = jnp.stack(
            [
                -(float(Minv_np[i, 0]) * qj + float(Minv_np[i, 1]) * qj1)
                for i in range(k - 1)
            ],
            axis=1,
        )  # (N, k-1, E)
        cell_blk = jnp.concatenate([qj[:, None, :], q_int], axis=1)  # (N, k, E)
        q_T = jnp.concatenate([cell_blk.reshape(N * k, E), q_chain[-1:]], axis=0)
        return q_T, p_T

    return g, Ftot, back


def _blocked_uniform_solve(
    asm: _assembly.HydraulicNetworkAssembler,
    plan: _BlockedPlan,
    R_data: jnp.ndarray,
    f_data: jnp.ndarray,
    start_pbc: jnp.ndarray,
    end_pbc: jnp.ndarray,
    R_mode: str,
    f_mode: str,
    level_scan: bool = False,
):
    """Fused condense→eliminate→back-substitute in the blocked layout.

    All runtime args are expected in INTERNAL edge order (host-permuted by
    ``prepare_args``; "cell"-mode coefficients as (N, E) j-major blocks);
    outputs come back internal — the host flatten maps them to the public
    layout.

    The condensation/back-substitution closed forms intentionally mirror
    :func:`_make_edge_data_uniform` / :func:`_make_edge_data_scalar` and
    :func:`_solution_blocks_T` (a change to either must be applied here
    too); equality between the blocked and general executors is pinned by
    ``tests/test_blocked.py`` and the on-device
    ``blocked vs general executor`` check in ``chip_smoke.py``."""
    mesh = asm.network
    N, E = mesh.N, mesh.num_edges
    dt = R_data.dtype
    h_e = jnp.asarray(
        np.asarray(mesh.edge_length)[plan.edge_order], dtype=dt
    ) / N
    W, g, Ftot, back = _blocked_condense(
        N, E, h_e, R_data, f_data, R_mode, f_mode, k=asm.flux_degree
    )
    w = 1.0 / W
    s_b = jnp.asarray(plan.s_is_bif)
    t_b = jnp.asarray(plan.t_is_bif)
    const = (-start_pbc * (~s_b) + end_pbc * (~t_b) - g) * w

    eliminate = _blocked_eliminate_scan if level_scan else _blocked_eliminate
    lam_lev, lam, rhs_norm = eliminate(plan, w, const, Ftot)
    lam_s, lam_t = _blocked_lambda_to_edges(plan, lam_lev, dt)

    r0 = jnp.where(s_b, lam_s, -start_pbc)
    rN = jnp.where(t_b, -lam_t, end_pbc)
    q0 = (r0 + rN - g) * w
    q_T, p_T = back(q0, r0)
    # Finiteness from the (E,)-sized precursors, NOT the (m, E) output
    # blocks: q_T/p_T are affine in (q0, r0, Ftot/W/g-derived data), so
    # checking the precursors is exactly as strong — and skips re-reading
    # ~40 MB of outputs (profiled at ~20% of the 16-gen device program).
    finite = (
        jnp.all(jnp.isfinite(q0))
        & jnp.all(jnp.isfinite(r0))
        & jnp.all(jnp.isfinite(lam))
        & jnp.all(jnp.isfinite(W))
        & jnp.all(jnp.isfinite(g))
        & jnp.all(jnp.isfinite(Ftot))
    )
    return q_T, p_T, lam, rhs_norm, finite



def _permute_coefficient(arr, mode: str, N: int, edge_order=None):
    """Host-side coefficient relayout: public order -> internal layout.

    ``scalar`` passes through; ``edge`` ``(E,)`` data reorders by
    ``edge_order`` (None = identity); ``cell`` ``(C,)`` public cell order
    becomes j-major ``(N, E)`` blocks (every condensation op contiguous
    along the lane axis).  The single shared implementation of the
    permutation used by the blocked executor and all three factorization
    pairs — the layout contract lives HERE, nowhere else."""
    a = np.asarray(arr)
    if mode == "scalar":
        return a
    if mode == "cell":
        a2 = a.reshape(a.size // N, N)
        if edge_order is not None:
            a2 = a2[edge_order]
        return np.ascontiguousarray(a2.T)
    return a if edge_order is None else a[edge_order]


class BlockedFactorization:
    """Factor-reuse serving pair for the blocked forest executor.

    The reference's KSP holds the MUMPS factorization and re-solves for
    new right-hand sides without refactorizing (reference
    ``solver.py:58-65``); this is the analog for the blocked
    fast layout: :meth:`factor` runs the resistance-side work once
    (condensed conductances + the eliminated per-level diagonals and
    elimination factors — a device-resident pytree), and :meth:`solve`
    runs only the rhs sweeps (source condensation, forward/backward
    r-recursions, back-substitution) against it.

    Both take PUBLIC-order coefficient arrays (host-permuted like
    ``_BlockedExecutor.prepare_args``); :meth:`solve` returns internal
    j-major blocks ``(q_T, p_T, lam, rhs_norm, finite)``;
    :meth:`solution_vector` maps them to the global flat layout.
    """

    solve_has_residual = False  # exact elimination: 5-tuple, no residual

    def __init__(self, asm: _assembly.HydraulicNetworkAssembler,
                 opts: "SolverOptions | None" = None):
        plan = _plan_blocked(asm)
        if plan is None:
            raise ValueError(
                "BlockedFactorization requires a blocked-eligible topology "
                "(uniformly-K-ary forest; see _plan_blocked)"
            )
        R_mode, f_mode, _ = asm.coefficient_modes()
        if R_mode not in ("scalar", "edge", "cell") or f_mode not in (
            "scalar", "edge", "cell"
        ):
            raise ValueError(
                "BlockedFactorization requires scalar/per-edge/per-cell "
                "coefficients (quad-mode callables stay on the fused path)"
            )
        opts = opts or SolverOptions()
        self._asm = asm
        self._plan = plan
        self._R_mode, self._f_mode = R_mode, f_mode
        mesh = asm.network
        self._N, self._E, self._k = mesh.N, mesh.num_edges, asm.flux_degree
        comp_dt = jnp.float32 if opts.dtype == "float32" else jnp.float64
        N, E, k = self._N, self._E, self._k
        h_e = jnp.asarray(
            np.asarray(mesh.edge_length)[plan.edge_order], dtype=comp_dt
        ) / N
        s_b = jnp.asarray(plan.s_is_bif)
        t_b = jnp.asarray(plan.t_is_bif)

        def factor_fn(R_rows):
            R_rows = jnp.asarray(R_rows, dtype=comp_dt)
            W, a1, a2 = _blocked_condense_R(N, E, h_e, R_rows, R_mode, k)
            w = 1.0 / W
            d_lev, wn_lev, factor_lev = _blocked_forward_factor(plan, w)
            return {
                "W": W, "w": w, "a1": a1, "a2": a2, "d_lev": d_lev,
                "wn_lev": wn_lev, "factor_lev": factor_lev,
            }

        def solve_fn(state, f_rows, spbc, epbc):
            f_rows = jnp.asarray(f_rows, dtype=comp_dt)
            spbc = jnp.asarray(spbc, dtype=comp_dt)
            epbc = jnp.asarray(epbc, dtype=comp_dt)
            g, Ftot, back = _blocked_condense_f(
                N, E, h_e, f_rows, f_mode, state["a1"], state["a2"], k
            )
            w = state["w"]
            const = (-spbc * (~s_b) + epbc * (~t_b) - g) * w
            d0, r0_root, _w0, saved, rhs_sq = _blocked_forward_apply(
                plan, state["d_lev"], state["wn_lev"], state["factor_lev"],
                const, Ftot,
            )
            lam_lev, lam = _blocked_backward(plan, saved, r0_root / d0)
            lam_s, lam_t = _blocked_lambda_to_edges(plan, lam_lev, comp_dt)
            r0 = jnp.where(s_b, lam_s, -spbc)
            rN = jnp.where(t_b, -lam_t, epbc)
            q0 = (r0 + rN - g) * w
            q_T, p_T = back(q0, r0)
            finite = (
                jnp.all(jnp.isfinite(q0))
                & jnp.all(jnp.isfinite(r0))
                & jnp.all(jnp.isfinite(lam))
                & jnp.all(jnp.isfinite(state["W"]))
                & jnp.all(jnp.isfinite(g))
                & jnp.all(jnp.isfinite(Ftot))
            )
            return q_T, p_T, lam, jnp.sqrt(rhs_sq), finite

        self._factor_fn = jax.jit(factor_fn)
        self._solve_fn = jax.jit(solve_fn)
        self._solve_batch_fn = jax.jit(
            jax.vmap(solve_fn, in_axes=(None, 0, 0, 0))
        )

    # -- host-side permutation (mirrors _BlockedExecutor._permute)
    def _permute(self, arr, mode):
        return _permute_coefficient(arr, mode, self._N, self._plan.edge_order)

    def factor(self, R_data):
        """Resistance-side factorization (device pytree, reusable)."""
        return self._factor_fn(self._permute(R_data, self._R_mode))

    def solve(self, state, f_data, start_pbc, end_pbc):
        """Solve against a cached factor for one rhs (f, boundary p)."""
        eo = self._plan.edge_order
        return self._solve_fn(
            state,
            self._permute(f_data, self._f_mode),
            np.asarray(start_pbc)[eo],
            np.asarray(end_pbc)[eo],
        )

    def solve_batch(self, state, f_batch, start_pbc_batch, end_pbc_batch):
        """Vmapped rhs sweep against one cached factor: args carry a
        leading scenario axis over the same per-rhs layouts as
        :meth:`solve`; returns batched blocks."""
        eo = self._plan.edge_order
        f_rows = np.stack(
            [self._permute(fb, self._f_mode) for fb in np.asarray(f_batch)]
        )
        return self._solve_batch_fn(
            state,
            f_rows,
            np.asarray(start_pbc_batch)[:, eo],
            np.asarray(end_pbc_batch)[:, eo],
        )

    def prepare_rhs(self, f_data, start_pbc, end_pbc):
        """Device-resident internally-ordered rhs args for
        :meth:`solve_prepared` — permute once, dispatch many (a serving
        loop that re-permuted per solve would pay a host round trip)."""
        eo = self._plan.edge_order
        return (
            jnp.asarray(self._permute(f_data, self._f_mode)),
            jnp.asarray(np.asarray(start_pbc)[eo]),
            jnp.asarray(np.asarray(end_pbc)[eo]),
        )

    def solve_prepared(self, state, rhs_args):
        """Solve against a cached factor with :meth:`prepare_rhs` args."""
        return self._solve_fn(state, *rhs_args)

    def solution_vector(self, out) -> np.ndarray:
        """Global flat block vector from a :meth:`solve` result."""
        q_T, p_T, lam = out[0], out[1], out[2]
        return _flatten_blocks_host(
            q_T, p_T, lam, self._asm.network.edge_color,
            edge_order=self._plan.edge_order,
            bif_order=self._plan.bif_order,
        )


def build_blocked_factorization(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: "SolverOptions | None" = None,
) -> BlockedFactorization:
    """Factor/solve pair for fixed-resistance serving (see
    :class:`BlockedFactorization`)."""
    return BlockedFactorization(asm, opts)


class GridFactorization:
    """Factor-reuse serving pair for the lattice (DCT) executor.

    The lattice analog of :class:`BlockedFactorization`: :meth:`factor`
    runs the conductance-side work once (condensed weights, the Schur
    diagonal grid, the separable eigenvalue inverse and the polished
    bordered-capacitance inverse — :func:`_dct_capacitance_factor`), and
    :meth:`solve` runs only the rhs work (source condensation, 2-D slice
    rhs assembly, the DCT direct+refine passes, expansion and
    back-substitution).  Requires the ``make_grid`` lattice envelope
    (scalar resistance; see :func:`_plan_grid_layout`)."""

    solve_has_residual = True  # 6-tuple: λ residual at out[-3]

    def __init__(self, asm: _assembly.HydraulicNetworkAssembler,
                 opts: "SolverOptions | None" = None):
        R_mode, f_mode, _ = asm.coefficient_modes()
        if R_mode != "scalar":
            raise ValueError(
                "GridFactorization requires scalar resistance (the "
                "separable-DCT envelope)"
            )
        if f_mode not in ("scalar", "edge", "cell"):
            raise ValueError(
                "GridFactorization requires scalar/per-edge/per-cell f"
            )
        shift_plan = _plan_shift_matvec(asm)
        dct = _plan_dct_lattice(asm, shift_plan) if shift_plan else None
        plan = _plan_grid_layout(asm, dct) if dct is not None else None
        if plan is None:
            raise ValueError(
                "GridFactorization requires a uniform rectangular-lattice "
                "multiplier graph (make_grid family)"
            )
        opts = opts or SolverOptions()
        self._asm = asm
        self._plan = plan
        self._R_mode, self._f_mode = R_mode, f_mode
        mesh = asm.network
        self._N, self._E, self._k = mesh.N, mesh.num_edges, asm.flux_degree
        comp_dt = jnp.float32 if opts.dtype == "float32" else jnp.float64
        N, E, k = self._N, self._E, self._k
        nx, ny, Ex, Ey = plan.nx, plan.ny, plan.Ex, plan.Ey
        h_e = jnp.asarray(plan.h_e, dtype=comp_dt)
        s_b = jnp.asarray(plan.s_is_bif)
        t_b = jnp.asarray(plan.t_is_bif)
        n_stub = int(plan.stub_rows_e.size)
        stub_rows = jnp.asarray(plan.stub_rows_e)
        stub_s = jnp.asarray(plan.stub_s_bif)
        r_dct = int(plan.dct.stub_rows.size)

        def x2d(v):
            return v[:Ex].reshape(ny, nx - 1)

        def y2d(v):
            return v[Ex : Ex + Ey].reshape(ny - 1, nx)

        def factor_fn(R_rows):
            R_rows = jnp.asarray(R_rows, dtype=comp_dt)
            W, a1, a2 = _blocked_condense_R(N, E, h_e, R_rows, R_mode, k)
            w = 1.0 / W
            wx2, wy2 = x2d(w), y2d(w)
            diag2 = jnp.zeros((ny, nx), comp_dt)
            diag2 = diag2.at[:, : nx - 1].add(wx2)
            diag2 = diag2.at[:, 1:].add(wx2)
            diag2 = diag2.at[: ny - 1, :].add(wy2)
            diag2 = diag2.at[1:, :].add(wy2)
            w_r = jnp.zeros(r_dct, comp_dt)
            if n_stub:
                diag2 = (
                    diag2.reshape(-1)
                    .at[stub_rows]
                    .add(w[Ex + Ey :])
                    .reshape(ny, nx)
                )
                w_r = w_r.at[jnp.asarray(plan.stub_group)].add(w[Ex + Ey :])
            cap = _dct_capacitance_factor(plan.dct, w[0], w[Ex], w_r, comp_dt)
            return {
                "W": W, "w": w, "a1": a1, "a2": a2, "diag2": diag2,
                "wx2": wx2, "wy2": wy2, "cap": cap,
            }

        def solve_fn(state, f_rows, spbc, epbc):
            f_rows = jnp.asarray(f_rows, dtype=comp_dt)
            spbc = jnp.asarray(spbc, dtype=comp_dt)
            epbc = jnp.asarray(epbc, dtype=comp_dt)
            g, Ftot, back = _blocked_condense_f(
                N, E, h_e, f_rows, f_mode, state["a1"], state["a2"], k
            )
            w = state["w"]
            const = (-spbc * (~s_b) + epbc * (~t_b) - g) * w
            cF = const + Ftot
            rhs2 = jnp.zeros((ny, nx), comp_dt)
            rhs2 = rhs2.at[:, 1:].add(x2d(cF))
            rhs2 = rhs2.at[:, : nx - 1].add(-x2d(const))
            rhs2 = rhs2.at[1:, :].add(y2d(cF))
            rhs2 = rhs2.at[: ny - 1, :].add(-y2d(const))
            if n_stub:
                rhs_st = jnp.where(stub_s, -const[Ex + Ey :], cF[Ex + Ey :])
                rhs2 = (
                    rhs2.reshape(-1).at[stub_rows].add(rhs_st).reshape(ny, nx)
                )
            rhs = rhs2.reshape(-1)
            diag2, wx2, wy2 = state["diag2"], state["wx2"], state["wy2"]

            def matvec(lam):
                l2 = lam.reshape(ny, nx)
                out = diag2 * l2
                out = out.at[:, : nx - 1].add(-wx2 * l2[:, 1:])
                out = out.at[:, 1:].add(-wx2 * l2[:, : nx - 1])
                out = out.at[: ny - 1, :].add(-wy2 * l2[1:, :])
                out = out.at[1:, :].add(-wy2 * l2[: ny - 1, :])
                return out.reshape(-1)

            lam = _dct_capacitance_apply(plan.dct, state["cap"], rhs, matvec)
            l2 = lam.reshape(ny, nx)
            parts_s = [l2[:, : nx - 1].reshape(-1), l2[: ny - 1, :].reshape(-1)]
            parts_t = [l2[:, 1:].reshape(-1), l2[1:, :].reshape(-1)]
            if n_stub:
                lam_st = lam[stub_rows]
                parts_s.append(jnp.where(stub_s, lam_st, 0.0))
                parts_t.append(jnp.where(stub_s, 0.0, lam_st))
            lam_s = jnp.concatenate(parts_s)
            lam_t = jnp.concatenate(parts_t)
            r0 = jnp.where(s_b, lam_s, -spbc)
            rN = jnp.where(t_b, -lam_t, epbc)
            q0 = (r0 + rN - g) * w
            q_T, p_T = back(q0, r0)
            residual = jnp.linalg.norm(matvec(lam) - rhs)
            rhs_norm = jnp.linalg.norm(rhs)
            finite = (
                jnp.all(jnp.isfinite(q0))
                & jnp.all(jnp.isfinite(r0))
                & jnp.all(jnp.isfinite(lam))
                & jnp.all(jnp.isfinite(state["W"]))
                & jnp.all(jnp.isfinite(g))
                & jnp.all(jnp.isfinite(Ftot))
            )
            return q_T, p_T, lam, residual, rhs_norm, finite

        self._factor_fn = jax.jit(factor_fn)
        self._solve_fn = jax.jit(solve_fn)
        self._solve_batch_fn = jax.jit(
            jax.vmap(solve_fn, in_axes=(None, 0, 0, 0))
        )

    def _permute(self, arr, mode):
        return _permute_coefficient(arr, mode, self._N, self._plan.edge_order)

    def factor(self, R_data):
        """Conductance-side factorization (device pytree, reusable)."""
        return self._factor_fn(self._permute(R_data, self._R_mode))

    def solve(self, state, f_data, start_pbc, end_pbc):
        """Solve against a cached factor for one rhs (f, boundary p)."""
        eo = self._plan.edge_order
        return self._solve_fn(
            state,
            self._permute(f_data, self._f_mode),
            np.asarray(start_pbc)[eo],
            np.asarray(end_pbc)[eo],
        )

    def solve_batch(self, state, f_batch, start_pbc_batch, end_pbc_batch):
        """Vmapped rhs sweep against one cached factor: args carry a
        leading scenario axis over the same per-rhs layouts as
        :meth:`solve`; returns batched blocks."""
        eo = self._plan.edge_order
        f_rows = np.stack(
            [self._permute(fb, self._f_mode) for fb in np.asarray(f_batch)]
        )
        return self._solve_batch_fn(
            state,
            f_rows,
            np.asarray(start_pbc_batch)[:, eo],
            np.asarray(end_pbc_batch)[:, eo],
        )

    def prepare_rhs(self, f_data, start_pbc, end_pbc):
        """Device-resident internally-ordered rhs args for
        :meth:`solve_prepared` — permute once, dispatch many (a serving
        loop that re-permuted per solve would pay a host round trip)."""
        eo = self._plan.edge_order
        return (
            jnp.asarray(self._permute(f_data, self._f_mode)),
            jnp.asarray(np.asarray(start_pbc)[eo]),
            jnp.asarray(np.asarray(end_pbc)[eo]),
        )

    def solve_prepared(self, state, rhs_args):
        """Solve against a cached factor with :meth:`prepare_rhs` args."""
        return self._solve_fn(state, *rhs_args)

    def solution_vector(self, out) -> np.ndarray:
        """Global flat block vector from a :meth:`solve` result."""
        q_T, p_T, lam = out[0], out[1], out[2]
        return _flatten_blocks_host(
            q_T, p_T, lam, self._asm.network.edge_color,
            edge_order=self._plan.edge_order,
            bif_order=self._plan.bif_order,
        )


def build_grid_factorization(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: "SolverOptions | None" = None,
) -> GridFactorization:
    """Factor/solve pair for fixed-conductance lattice serving (see
    :class:`GridFactorization`)."""
    return GridFactorization(asm, opts)


# Memoized jax.device_put of core-elimination plans: an executor and a
# TreeFactorization built from the same assembler (the bench's
# factor-reuse stage holds both) must SHARE the device-resident index
# payload — at supernodal scale it is hundreds of MB of HBM, and each
# build_schur_executor/TreeFactorization call used to transfer its own
# copy.  Plans are NamedTuples (no weakrefs, no attribute slots), so the
# cache is keyed by id() and holds a strong reference to the host plan,
# which keeps the id valid for the entry's lifetime; a small FIFO bound
# caps host/HBM retention.
_CPLAN_DEV_CACHE: "collections.OrderedDict[int, tuple]" = (
    collections.OrderedDict()
)


def _cached_tree_plan(asm, force_rounds: bool = False, attach: bool = False):
    """Memoized :func:`_plan_tree_elimination` / :func:`attach_core_plan`.

    The structural elimination plan depends only on the network topology,
    which is fixed at assembler construction — so the fused executor, a
    :class:`TreeFactorization`, the sharded solver and the bench harness
    built over the SAME assembler share one plan object.  That makes the
    host symbolic phase (tens of seconds at 320² supernodal scale) a
    once-per-assembler cost, and lets :func:`_device_core_plan` share the
    multi-hundred-MB device payload across executables.  The attached
    core plan is additionally shared across the ``force_rounds`` variants
    (it is a function of ``core_pairs`` only, identical in both)."""
    cache = asm.__dict__.setdefault("_nxfx_plan_cache", {})
    key = ("plan", force_rounds)
    if key not in cache:
        cache[key] = _plan_tree_elimination(asm, force_rounds=force_rounds)
    plan = cache[key]
    if not attach or plan is None or plan.core_size == 0:
        return plan
    akey = ("attached", force_rounds)
    if akey not in cache:
        other = cache.get(("attached", not force_rounds))
        if other is not None and other.core_plan is not None:
            cache[akey] = plan._replace(core_plan=other.core_plan)
        else:
            cache[akey] = attach_core_plan(plan)
    return cache[akey]


def _device_core_plan(core_plan):
    key = id(core_plan)
    hit = _CPLAN_DEV_CACHE.get(key)
    if hit is not None and hit[0] is core_plan:
        _CPLAN_DEV_CACHE.move_to_end(key)
        return hit[1]
    dev = jax.device_put(core_plan)
    _CPLAN_DEV_CACHE[key] = (core_plan, dev)
    while len(_CPLAN_DEV_CACHE) > 4:
        _CPLAN_DEV_CACHE.popitem(last=False)
    return dev


class TreeFactorization:
    """Factor-reuse serving pair for ANY topology (peel-then-core path).

    The general-topology completion of :class:`BlockedFactorization` /
    :class:`GridFactorization` — the full MUMPS factor-reuse contract
    (the reference's KSP retains the factorization across solves,
    reference ``solver.py:58-65``) on arbitrary networks: :meth:`factor`
    runs the resistance-side work once (condensed conductances, per-pair
    aggregation, the peeled diagonal eliminations, and the cycle-core
    factorization — sparse minimum-degree value elimination or dense
    Cholesky), :meth:`solve` only the rhs half.  Solution blocks come
    back in PUBLIC edge order (no internal layout / permutation).
    """

    solve_has_residual = False  # exact elimination: 5-tuple, no residual

    def __init__(self, asm: _assembly.HydraulicNetworkAssembler,
                 opts: "SolverOptions | None" = None,
                 _tree_plan: "_TreePlan | None" = None):
        R_mode, f_mode, _ = asm.coefficient_modes()
        if R_mode not in ("scalar", "edge", "cell") or f_mode not in (
            "scalar", "edge", "cell"
        ):
            raise ValueError(
                "TreeFactorization requires scalar/per-edge/per-cell "
                "coefficients (quad-mode callables stay on the fused path)"
            )
        # force_rounds: the forest fast path returns rounds=() (the fused
        # path's level plan supersedes them), but THIS class executes the
        # peel rounds directly — without them an irregular forest would
        # silently return λ = 0.  _tree_plan: test-only injection of a
        # forced plan (e.g. tiny supernodal fronts), as in
        # build_schur_executor.
        plan = _tree_plan
        if plan is None:
            plan = _cached_tree_plan(asm, force_rounds=True)
        if plan is None:
            raise ValueError("TreeFactorization requires multipliers (B > 0)")
        if plan.core_size == 0 and len(plan.rounds) == 0:
            # defensive: with B > 0 an empty plan would solve nothing
            raise ValueError(
                "TreeFactorization got an empty elimination plan for a "
                "graph with multipliers — this is a bug, please report"
            )
        if plan.core_size > 512:
            plan = (
                _cached_tree_plan(asm, force_rounds=True, attach=True)
                if _tree_plan is None
                else attach_core_plan(plan)
            )
        if plan.core_size > 4096 and plan.core_plan is None:
            raise ValueError(
                "cycle core too large for the tree factorization (the "
                "sparse-elimination fill budget was exceeded; the fused "
                "dense/CG path keeps serving it)"
            )
        opts = opts or SolverOptions()
        self._asm = asm
        self._plan = plan
        self._R_mode, self._f_mode = R_mode, f_mode
        mesh = asm.network
        self._N, self._E, self._k = mesh.N, mesh.num_edges, asm.flux_degree
        N, E, k = self._N, self._E, self._k
        comp_dt = jnp.float32 if opts.dtype == "float32" else jnp.float64
        B = mesh.num_multipliers
        h_e = jnp.asarray(np.asarray(mesh.edge_length), dtype=comp_dt) / N
        s_bif = np.asarray(asm._edge_start_bif)
        t_bif = np.asarray(asm._edge_end_bif)
        s_b = jnp.asarray(s_bif >= 0)
        t_b = jnp.asarray(t_bif >= 0)
        s_idx = jnp.asarray(np.where(s_bif >= 0, s_bif, 0))
        t_idx = jnp.asarray(np.where(t_bif >= 0, t_bif, 0))
        s_pad = jnp.asarray(np.where(s_bif >= 0, s_bif, B))
        t_pad = jnp.asarray(np.where(t_bif >= 0, t_bif, B))
        P = plan.pair_nodes.shape[0]
        ep_sel = np.flatnonzero(plan.edge_pair >= 0)
        ep_ids = plan.edge_pair[ep_sel]

        def factor_fn(R_data, cplan=None):
            R_data = jnp.asarray(R_data, dtype=comp_dt)
            W, a1, a2 = _blocked_condense_R(N, E, h_e, R_data, R_mode, k)
            w = 1.0 / W
            diag = jnp.zeros(B, comp_dt)
            diag = diag.at[t_idx].add(jnp.where(t_b, w, 0.0))
            diag = diag.at[s_idx].add(jnp.where(s_b, w, 0.0))
            if P:
                w_pairs = jnp.zeros(P, comp_dt).at[jnp.asarray(ep_ids)].add(
                    w[jnp.asarray(ep_sel)]
                )
            else:
                w_pairs = jnp.zeros(0, comp_dt)
            tree_state = _tree_eliminate_factor(
                plan, diag, w_pairs, core_plan=cplan
            )
            return {"W": W, "w": w, "a1": a1, "a2": a2, "tree": tree_state}

        def solve_fn(state, f_data, spbc, epbc, cplan=None):
            f_data = jnp.asarray(f_data, dtype=comp_dt)
            spbc = jnp.asarray(spbc, dtype=comp_dt)
            epbc = jnp.asarray(epbc, dtype=comp_dt)
            g, Ftot, back = _blocked_condense_f(
                N, E, h_e, f_data, f_mode, state["a1"], state["a2"], k
            )
            w = state["w"]
            const = (-spbc * (~s_b) + epbc * (~t_b) - g) * w
            rhs = jnp.zeros(B, comp_dt)
            rhs = rhs.at[t_idx].add(jnp.where(t_b, const + Ftot, 0.0))
            rhs = rhs.at[s_idx].add(jnp.where(s_b, -const, 0.0))
            lam = _tree_eliminate_apply(
                plan, state["tree"], rhs, core_plan=cplan
            )
            lam_pad = jnp.concatenate([lam, jnp.zeros(1, comp_dt)])
            r0 = jnp.where(s_b, lam_pad[s_pad], -spbc)
            rN = jnp.where(t_b, -lam_pad[t_pad], epbc)
            q0 = (r0 + rN - g) * w
            q_T, p_T = back(q0, r0)
            finite = (
                jnp.all(jnp.isfinite(q0))
                & jnp.all(jnp.isfinite(r0))
                & jnp.all(jnp.isfinite(lam))
                & jnp.all(jnp.isfinite(state["W"]))
                & jnp.all(jnp.isfinite(g))
                & jnp.all(jnp.isfinite(Ftot))
            )
            return q_T, p_T, lam, jnp.linalg.norm(rhs), finite

        # The core plan rides along as a runtime argument (device
        # buffers shared by the factor/solve/batch programs) rather than
        # HLO literal constants — see the pytree registration in
        # ops/core_elim.py.  Memoized: a fused executor built from the
        # same assembler reuses these buffers instead of doubling the
        # multi-hundred-MB payload in HBM.
        self._cplan_dev = (
            _device_core_plan(plan.core_plan)
            if plan.core_plan is not None
            else None
        )
        self._factor_fn = jax.jit(factor_fn)
        self._solve_fn = jax.jit(solve_fn)
        self._solve_batch_fn = jax.jit(
            jax.vmap(solve_fn, in_axes=(None, 0, 0, 0, None))
        )

    def _prep_coeff(self, arr, mode):
        # public edge order is the tree path's internal order (no reorder)
        return _permute_coefficient(arr, mode, self._N, edge_order=None)

    def factor(self, R_data):
        """Resistance-side factorization (device pytree, reusable)."""
        return self._factor_fn(
            self._prep_coeff(R_data, self._R_mode), self._cplan_dev
        )

    def solve(self, state, f_data, start_pbc, end_pbc):
        """Solve against a cached factor for one rhs (f, boundary p)."""
        return self._solve_fn(
            state,
            self._prep_coeff(f_data, self._f_mode),
            np.asarray(start_pbc),
            np.asarray(end_pbc),
            self._cplan_dev,
        )

    def solve_batch(self, state, f_batch, start_pbc_batch, end_pbc_batch):
        """Vmapped rhs sweep against one cached factor."""
        f_rows = np.stack(
            [self._prep_coeff(fb, self._f_mode) for fb in np.asarray(f_batch)]
        )
        return self._solve_batch_fn(
            state,
            f_rows,
            np.asarray(start_pbc_batch),
            np.asarray(end_pbc_batch),
            self._cplan_dev,
        )

    def prepare_rhs(self, f_data, start_pbc, end_pbc):
        """Device-resident rhs args for :meth:`solve_prepared`."""
        return (
            jnp.asarray(self._prep_coeff(f_data, self._f_mode)),
            jnp.asarray(np.asarray(start_pbc)),
            jnp.asarray(np.asarray(end_pbc)),
        )

    def solve_prepared(self, state, rhs_args):
        """Solve against a cached factor with :meth:`prepare_rhs` args."""
        return self._solve_fn(state, *rhs_args, self._cplan_dev)

    def solution_vector(self, out) -> np.ndarray:
        """Global flat block vector from a :meth:`solve` result."""
        q_T, p_T, lam = out[0], out[1], out[2]
        return _flatten_blocks_host(
            q_T, p_T, lam, self._asm.network.edge_color,
            edge_order=None, bif_order=None,
        )


def build_tree_factorization(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: "SolverOptions | None" = None,
    _tree_plan=None,
) -> TreeFactorization:
    """Factor/solve pair for fixed-resistance serving on ANY topology
    (see :class:`TreeFactorization`)."""
    return TreeFactorization(asm, opts, _tree_plan=_tree_plan)


def _tree_schur_solve(
    plan: _TreePlan,
    diag: jnp.ndarray,
    rhs: jnp.ndarray,
    w_edges: jnp.ndarray,
    both_mask: jnp.ndarray,
    core_plan=None,
) -> jnp.ndarray:
    """Solve L λ = rhs by fill-in-free elimination along the static plan.

    O(B) work in ~tree-depth rounds of vectorized gathers/scatters — the
    speed-of-light direct solve for tree networks (every reference
    benchmark), replacing both MUMPS and iterative methods.

    ``core_plan``: optional override of ``plan.core_plan`` whose index
    arrays are TRACED values (the plan passed as a jit argument — device
    buffers instead of HLO literal constants; see the pytree registration
    in ``ops/core_elim.py``).
    """
    P = plan.pair_nodes.shape[0]
    if P > 0:
        sel = np.flatnonzero(plan.edge_pair >= 0)
        ids = plan.edge_pair[sel]
        order = np.argsort(ids, kind="stable")
        w_pairs = _segsum_sorted(w_edges, ids[order], P, sel=sel[order])
    else:
        w_pairs = jnp.zeros(0, dtype=diag.dtype)
    return _tree_eliminate(plan, diag, rhs, w_pairs, core_plan=core_plan)


def _tree_eliminate(
    plan: _TreePlan, diag: jnp.ndarray, rhs: jnp.ndarray, w_pairs: jnp.ndarray,
    core_plan=None,
) -> jnp.ndarray:
    """Forward-eliminate and back-substitute along the static peel order,
    given aggregated per-pair conductances (callers may psum these across
    devices).  Internally split into the conductance-side factor and the
    per-rhs apply so factor-reuse serving (:class:`TreeFactorization`)
    shares the exact same formulas."""
    return _tree_eliminate_apply(
        plan, _tree_eliminate_factor(plan, diag, w_pairs, core_plan=core_plan),
        rhs, core_plan=core_plan,
    )


def _tree_eliminate_factor(
    plan: _TreePlan, diag: jnp.ndarray, w_pairs: jnp.ndarray, core_plan=None
) -> dict:
    """Conductance-side half of the peel-then-core elimination.

    Eliminated diagonals + per-round factors, plus the core factorization
    (sparse value elimination or dense Cholesky) — everything that depends
    on the resistance data only (the MUMPS-factor analog)."""
    P = plan.pair_nodes.shape[0]
    d = diag
    rounds: list = []
    for elim, parents, pair_ids in plan.rounds:
        e = jnp.asarray(elim)  # host-sorted ascending, unique
        par = jnp.asarray(parents)
        has_par = par >= 0
        if P > 0:
            w = jnp.where(has_par, w_pairs[jnp.where(pair_ids >= 0, pair_ids, 0)], 0.0)
        else:
            w = jnp.zeros(elim.shape[0], dtype=diag.dtype)
        db = d[e]
        factor = w / db
        # Fold the parent updates with gathers only (host-planned exact
        # tree sums + inverse-map apply, fixed summation order) instead of
        # segment_sum / scatter-add.
        sel_np = np.flatnonzero(parents >= 0)
        upar, inv = np.unique(parents[sel_np], return_inverse=True)
        if upar.size:
            from .ops.core_elim import _fold_apply, _inverse_map, _plan_fold

            fold = _plan_fold(inv, upar.size, sel_np, int(parents.size))
            dinv = jnp.asarray(
                _inverse_map(upar, int(d.shape[0]), upar.size)
            )
            s = _fold_apply(-w * factor, fold)
            s_ext = jnp.concatenate([s, jnp.zeros(1, d.dtype)])
            d = d + s_ext[dinv]
        rounds.append((w, db, factor))

    state: dict = {"rounds": tuple(rounds)}
    if plan.core_size > 0 and plan.core_plan is not None:
        # Sparse elimination of the cycle core (ops/core_elim.py): exact
        # host-planned min-degree rounds — the MUMPS-generality path for
        # large unstructured cores (reference solver.py:62).
        from .ops.core_elim import _core_factor

        cn = jnp.asarray(plan.core_nodes)
        state["core"] = _core_factor(
            core_plan if core_plan is not None else plan.core_plan,
            d[cn], w_pairs,
        )
    elif plan.core_size > 0:
        # Dense factor of the residual cycle core: peeled diagonals are
        # already folded into d; off-diagonals are the original core pair
        # conductances (Jacobi-scaled Cholesky like the dense path).
        cn = jnp.asarray(plan.core_nodes)
        Bc = plan.core_size
        Lc = jnp.zeros((Bc, Bc), dtype=diag.dtype)
        Lc = Lc.at[jnp.arange(Bc), jnp.arange(Bc)].add(d[cn])
        if plan.core_pairs.shape[0] > 0:
            ci = jnp.asarray(plan.core_pairs[:, 0])
            cj = jnp.asarray(plan.core_pairs[:, 1])
            wv = w_pairs[jnp.asarray(plan.core_pairs[:, 2])]
            Lc = Lc.at[ci, cj].add(-wv)
            Lc = Lc.at[cj, ci].add(-wv)
        state["core_dense"] = scaled_cholesky_factor(Lc)
    return state


def _tree_eliminate_apply(
    plan: _TreePlan, state: dict, rhs: jnp.ndarray, core_plan=None
) -> jnp.ndarray:
    """Per-rhs half: forward rhs sweeps, core solve, back-substitution."""
    r = rhs
    saved = []
    for (elim, parents, _pair_ids), (w, db, factor) in zip(
        plan.rounds, state["rounds"]
    ):
        e = jnp.asarray(elim)
        par = jnp.asarray(parents)
        has_par = par >= 0
        par_safe = jnp.where(has_par, par, 0)
        rb = r[e]
        sel_np = np.flatnonzero(parents >= 0)
        upar, inv = np.unique(parents[sel_np], return_inverse=True)
        if upar.size:
            # gather-fold + inverse-map apply (see _tree_eliminate_factor)
            from .ops.core_elim import _fold_apply, _inverse_map, _plan_fold

            fold = _plan_fold(inv, upar.size, sel_np, int(parents.size))
            rinv = jnp.asarray(
                _inverse_map(upar, int(r.shape[0]), upar.size)
            )
            s = _fold_apply(factor * rb, fold)
            s_ext = jnp.concatenate([s, jnp.zeros(1, r.dtype)])
            r = r + s_ext[rinv]
        saved.append((e, par_safe, has_par, w, db, rb))

    lam = jnp.zeros_like(rhs)
    if plan.core_size > 0:
        cn = jnp.asarray(plan.core_nodes)
        if plan.core_plan is not None:
            from .ops.core_elim import _core_apply

            lam_core = _core_apply(
                core_plan if core_plan is not None else plan.core_plan,
                state["core"], r[cn],
            )
        else:
            lam_core = scaled_cholesky_solve(state["core_dense"], r[cn])
        # scatter-set -> gather through a host inverse map
        from .ops.core_elim import _inverse_map

        cinv = jnp.asarray(
            _inverse_map(
                np.asarray(plan.core_nodes), int(lam.shape[0]),
                plan.core_nodes.size,
            )
        )
        lam_ext = jnp.concatenate([lam_core, jnp.zeros(1, lam.dtype)])
        lam = jnp.where(cinv < plan.core_nodes.size, lam_ext[cinv], lam)
    for (elim, _pa, _pi), (e, par_safe, has_par, w, db, rb) in zip(
        reversed(plan.rounds), reversed(saved)
    ):
        lam_par = jnp.where(has_par, lam[par_safe], 0.0)
        new = (rb + w * lam_par) / db
        # scatter-set -> select + gather through a host inverse map
        from .ops.core_elim import _inverse_map

        einv = jnp.asarray(
            _inverse_map(np.asarray(elim), int(lam.shape[0]), elim.shape[0])
        )
        new_ext = jnp.concatenate([new, jnp.zeros(1, lam.dtype)])
        lam = jnp.where(einv < elim.shape[0], new_ext[einv], lam)
    return lam


class _BlockedExecutor:
    """Callable wrapper carrying the blocked layout's host-side metadata.

    ``prepare_args`` permutes the public-order coefficient args into the
    plan's internal edge order (host numpy — done once per coefficient
    set, off the dispatch path); ``edge_order``/``bif_order`` let the
    host flatten map outputs back to the public layout."""

    blocks_out = True  # always the 7-tuple blocks contract

    def __init__(self, fn, plan: _BlockedPlan, R_mode: str, f_mode: str, N: int = 1):
        self._fn = fn
        self.blocked_plan = plan
        self.edge_order = plan.edge_order
        self.bif_order = plan.bif_order
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._N = N

    def __call__(self, *args):
        return self._fn(*args)

    def lower(self, *args):
        return self._fn.lower(*args)

    def _permute(self, arr, mode):
        return _permute_coefficient(arr, mode, self._N, self.edge_order)

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        eo = self.edge_order
        return (
            self._permute(R_data, self._R_mode),
            self._permute(f_data, self._f_mode),
            np.asarray(start_pbc)[eo],
            np.asarray(end_pbc)[eo],
        )


def lattice_solve_applicable(asm: _assembly.HydraulicNetworkAssembler) -> bool:
    """Host-side check: would the exact separable-DCT lattice solve engage?

    True when the multiplier graph is a uniform rectangular lattice
    (``make_grid`` family) and the resistance coefficient is scalar —
    the envelope of :func:`_plan_dct_lattice`.  Used by
    :func:`networks_fenicsx_tpu.batch.solve_sweep` to decide between the
    vmapped DCT solve and the batched dense-Cholesky fallback for
    small-to-medium bifurcation counts."""
    if asm.network.num_multipliers == 0:
        return False
    R_mode, _, _ = asm.coefficient_modes()
    if R_mode != "scalar":
        return False
    shift_plan = _plan_shift_matvec(asm)
    if shift_plan is None:
        return False
    return _plan_dct_lattice(asm, shift_plan) is not None


def build_schur_executor(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: SolverOptions,
    jit: bool = True,
    inputs: str = "coefficients",
    elide_zero_f: bool = True,
    outputs: str = "flat",
    internal_layout: bool = False,
    _tree_plan=None,
):
    """Build the (optionally jitted) end-to-end Schur solve.

    One fused XLA executable covers element-matrix formation (batched
    quadrature einsum — the per-cell kernels FFCx would codegen for the
    reference, ``assembly.py:288-299``), static condensation, the
    bifurcation-Laplacian solve and back-substitution.  All graph index
    arrays and basis tables are baked into the traced program as constants
    (demo_perf's "Compile"/"CompileCached" phases time exactly this first
    trace vs. cached-executable dispatch).

    Args:
        inputs: ``"coefficients"`` — executor signature is
            ``(R_quad (C, nq), f_quad (C, nq), start_pbc (E,), end_pbc (E,))``
            with element formation on-device (smallest host→device traffic);
            ``"cell_mass"`` — signature is ``(cell_mass (C, k+1, k+1),
            cell_f_int (C,), start_pbc, end_pbc)`` for precomputed element
            matrices.
        elide_zero_f: When the forms were computed with a zero scalar source
            the traced program skips the source cumsums (and thereafter
            ignores its ``f_data`` argument).  Pass ``False`` when the
            executor will be fed varying ``f`` values (e.g. vmapped source
            sweeps).
        outputs: ``"flat"`` — executor returns ``(x, iters, residual,
            rhs_norm, finite)`` with ``x`` the global block vector (the
            reference's PETSc-vector layout; costs a device relayout +
            concat pass over all dofs).  ``"blocks"`` — returns
            ``(q_T, p_T, lam, iters, residual, rhs_norm, finite)`` with
            the solution in j-major device blocks (see
            :func:`_solution_blocks_T`): the fast serving contract, used
            by :class:`Solver` and the benchmark.
    """
    mesh = asm.network
    B = mesh.num_multipliers
    schur_method = opts.schur_method
    tree_plan = None
    lam_plan = None
    R_mode, f_mode, f_zero = (
        asm.coefficient_modes() if inputs == "coefficients" else (None, None, False)
    )
    if schur_method in ("auto", "tree") and B > 0:
        # _tree_plan: test/tooling override (e.g. a core plan attached
        # with a non-default dense_cutoff to force the sparse rounds)
        tree_plan = (
            _tree_plan if _tree_plan is not None else _cached_tree_plan(asm)
        )
    if schur_method == "auto":
        # Peel-then-core elimination is exact for any graph; small cycle
        # cores stay dense.  Large cores first try the exact separable-DCT
        # lattice solve (checked below via the dense/cg resolution), then
        # the sparse min-degree core elimination (attach_core_plan), and
        # only fall to dense/CG when neither structure exists.
        if tree_plan is not None and tree_plan.core_size <= 512:
            schur_method = "tree"
        else:
            is_lattice = R_mode == "scalar" and lattice_solve_applicable(asm)
            if not is_lattice and tree_plan is not None:
                tree_plan = (
                    _cached_tree_plan(asm, attach=True)
                    if _tree_plan is None
                    else attach_core_plan(tree_plan)
                )
            if tree_plan is not None and (
                tree_plan.core_plan is not None or tree_plan.core_size <= 4096
            ):
                schur_method = "tree"
            else:
                schur_method = "dense" if B <= 4096 else "cg"
    elif schur_method == "tree" and tree_plan is not None and tree_plan.core_size > 512:
        # Explicitly requested tree path: apply the same core envelope as
        # "auto" — a large cycle core otherwise materialises an
        # O(core²)-memory dense factor (e.g. ~80 GB at a 100k-node core).
        tree_plan = (
            _cached_tree_plan(asm, attach=True)
            if _tree_plan is None
            else attach_core_plan(tree_plan)
        )
        if tree_plan.core_plan is None and tree_plan.core_size > 4096:
            raise ValueError(
                f"schur_method='tree' on a graph whose cycle core has "
                f"{tree_plan.core_size} nodes: the sparse core elimination "
                "could not be planned (fill budget / size cap) and a dense "
                "core factor would need O(core²) memory — use "
                "schur_method='auto' (CG+multigrid) or method='host_lu'"
            )
    level_plan = None
    matvec_plan = None
    shift_plan = None
    if schur_method == "tree" and B > 0:
        level_plan = _plan_level_elimination(asm, tree_plan)
        if level_plan is None:
            lam_plan = _build_lambda_plan(asm)
    elif B > 0:
        # dense / cg: assemble diag+rhs through the sorted host plan and run
        # the matvec scatter-free (both fold through host gather matrices).
        lam_plan = _build_lambda_plan(asm)
        matvec_plan = _build_matvec_plan(asm)
        shift_plan = _plan_shift_matvec(asm)
    # Uniform-lattice direct solve (exact, O(B log B)): auto-engaged when
    # "auto" resolved to the CG *or dense* path and the structure admits
    # it (a lattice's cycle core is the whole grid, so small lattices
    # resolve to dense — the DCT solve is exact and beats the B² dense
    # apply, and it vmaps without a per-scenario Cholesky in sweeps);
    # schur_method="dct" forces it.  An explicitly requested "cg"/"dense"
    # stays put (iteration-count tests and preconditioner studies rely
    # on it).
    dct_plan = None
    if (
        B > 0
        and R_mode == "scalar"
        and (
            schur_method == "dct"
            or (opts.schur_method == "auto" and schur_method in ("cg", "dense"))
        )
    ):
        if shift_plan is None:
            shift_plan = _plan_shift_matvec(asm)
        if shift_plan is not None:
            dct_plan = _plan_dct_lattice(asm, shift_plan)
    if schur_method == "dct" and dct_plan is None:
        raise ValueError(
            "schur_method='dct' requires a uniform rectangular-lattice "
            "multiplier graph (make_grid family) with scalar resistance"
        )
    # The zero-source elision is a *variant* of the traced program, valid
    # only while f stays zero; callers that feed varying f through the
    # executor's f argument (batched sweeps) must pass elide_zero_f=False.
    # Executor caches key on coefficient_modes(), which includes f_zero.
    f_is_zero = f_zero and elide_zero_f

    # SolverOptions.dtype = "float32" switches the whole fused solve to
    # single precision (a serving mode; expect ~1e-5 relative accuracy
    # instead of the f64 contract).
    comp_dt = jnp.float32 if opts.dtype == "float32" else jnp.float64
    # output_dtype = "float32" with a float64 solve is the mixed serving
    # contract: values carry f64-solve accuracy (rounded once on output)
    # while the big solution blocks leave the program in f32, halving
    # output bytes (see SolverOptions docs).
    if opts.output_dtype == "same":
        out_dt = comp_dt
    else:
        out_dt = jnp.float32 if opts.output_dtype == "float32" else jnp.float64

    # Lattice fast path (see _plan_grid_layout): gather-free device
    # program for uniform rectangular grids on top of the exact DCT λ
    # solve.  Same internal-layout opt-in contract as the forest blocked
    # path below.
    if (
        dct_plan is not None
        and internal_layout
        and outputs == "blocks"
        and inputs == "coefficients"
        and f_mode in ("scalar", "edge", "cell")
    ):
        grid_plan = _plan_grid_layout(asm, dct_plan)
        if grid_plan is not None:
            core_grid = _grid_blocked_core(
                asm, grid_plan, R_mode, f_mode, comp_dt, out_dt
            )
            ex_grid = _BlockedExecutor(
                jax.jit(core_grid) if jit else core_grid,
                grid_plan,
                R_mode,
                f_mode,
                N=mesh.N,
            )
            # conditioning hint for the λ-residual convergence gate: an
            # n-wide lattice Laplacian has κ ≈ n², and NO backward-stable
            # f64 direct method (host LU included) lands its residual
            # below ~κ·ε·‖rhs‖ — see _schur_solve.
            ex_grid.kappa_hint = float(max(dct_plan.s, dct_plan.ny)) ** 2
            return ex_grid

    # Blocked-sibling fast path (see _BlockedPlan): interleave-free device
    # program for uniformly-binary forests.  Requires internally-ordered
    # args, so it only activates when the caller opted in (Solver, bench);
    # anything outside its topology/coefficient envelope falls back.
    blocked_plan = None
    if (
        internal_layout
        and outputs == "blocks"
        and inputs == "coefficients"
        and schur_method == "tree"
        and level_plan is not None
        and R_mode in ("scalar", "edge", "cell")
        and f_mode in ("scalar", "edge", "cell")
    ):
        blocked_plan = _plan_blocked(asm)

    if blocked_plan is not None:
        plan = blocked_plan

        def core_blocked(arg0, arg1, start_pbc, end_pbc):
            arg0 = jnp.asarray(arg0, dtype=comp_dt)
            arg1 = jnp.asarray(arg1, dtype=comp_dt)
            start_pbc = jnp.asarray(start_pbc, dtype=comp_dt)
            end_pbc = jnp.asarray(end_pbc, dtype=comp_dt)
            q_T, p_T, lam, rhs_norm, finite = _blocked_uniform_solve(
                asm, plan, arg0, arg1, start_pbc, end_pbc, R_mode, f_mode,
                level_scan=(opts.level_scan == "on"),
            )
            iters = jnp.zeros((), dtype=jnp.int32)
            residual = jnp.zeros((), dtype=comp_dt)
            return (
                q_T.astype(out_dt),
                p_T.astype(out_dt),
                lam.astype(out_dt),
                iters,
                residual,
                rhs_norm,
                finite,
            )

        return _BlockedExecutor(
            jax.jit(core_blocked) if jit else core_blocked,
            plan,
            R_mode,
            f_mode,
            N=mesh.N,
        )

    def _finish(ed, cplan=None):
        """λ solve + back-substitution given condensed edge data."""
        if B > 0 and schur_method == "tree":
            # Direct elimination — no residual matvec; correctness is
            # guarded by the core pivot check and the finiteness flag.
            if level_plan is not None:
                # Forest: fully scatter-free level-ordered elimination.
                lam, rhs_norm = _level_eliminate(level_plan, ed, B)
            else:
                # Cycle core present: sorted assembly + peel-then-core.
                diag, rhs = _lambda_system_sorted(ed, B, lam_plan)
                lam = _tree_schur_solve(
                    tree_plan, diag, rhs, 1.0 / ed.W, None, core_plan=cplan
                )
                rhs_norm = jnp.linalg.norm(rhs)
            iters = jnp.zeros((), dtype=jnp.int32)
            residual = jnp.zeros(())
        elif B > 0:
            if matvec_plan is not None:
                diag, rhs = _lambda_system_sorted(ed, B, lam_plan)
                if shift_plan is not None:
                    matvec = _matvec_from_shift_plan(ed, diag, shift_plan, B)
                else:
                    matvec = _matvec_from_plan(ed, diag, matvec_plan, B)
                s_is_bif = ed.start_bif >= 0
                t_is_bif = ed.end_bif >= 0
                both = s_is_bif & t_is_bif
                s_idx = jnp.where(s_is_bif, ed.start_bif, 0)
                t_idx = jnp.where(t_is_bif, ed.end_bif, 0)
                off_w = jnp.where(both, 1.0 / ed.W, 0.0)
            else:  # pragma: no cover - kept for completeness
                matvec, diag, rhs, (s_idx, t_idx, off_w, both) = _schur_lambda_system(ed, B)
            if dct_plan is not None:
                # exact separable-DCT direct solve (uniform lattice); takes
                # precedence over whatever "auto" resolved to — the plan is
                # only built for auto/dct (see the gate above), so an
                # explicitly requested dense/cg never lands here.
                lam = _dct_lattice_solve(dct_plan, ed, rhs, matvec)
                iters = jnp.zeros((), dtype=jnp.int32)
            elif schur_method == "dense":
                L = jnp.zeros((B, B), dtype=ed.W.dtype)
                L = L.at[jnp.arange(B), jnp.arange(B)].add(diag)
                L = L.at[s_idx, t_idx].add(-off_w)
                L = L.at[t_idx, s_idx].add(-off_w)
                # the shared Jacobi-scaled Cholesky, incl. the singularity
                # pivot gate (the MUMPS zero-pivot analog)
                lam = scaled_cholesky_solve(scaled_cholesky_factor(L), rhs)
                iters = jnp.zeros((), dtype=jnp.int32)
            else:
                if opts.cg_precond not in ("auto", "mg", "chebyshev", "jacobi"):
                    raise ValueError(
                        f"unknown cg_precond {opts.cg_precond!r}; expected "
                        "'auto', 'mg', 'chebyshev' or 'jacobi'"
                    )
                mg_kind = None
                deltas = [c[0] for c in shift_plan] if shift_plan else []
                if shift_plan is not None and opts.cg_precond in ("auto", "mg"):
                    # auto: the V-cycle's fixed overhead (unrolled levels +
                    # per-solve coarse Cholesky) only wins above ~32k
                    # multipliers (measured: 128^2 lattice 41 ms Chebyshev
                    # vs 71 ms MG; 512^2 1.90 s vs 0.28 s)
                    if opts.cg_precond == "mg" or B > 32768:
                        strides = sorted({abs(d) for d in deltas} - {1})
                        row_ok = True
                        for d, rows, _ in shift_plan:
                            # ±1 couplings must not cross 2-D row boundaries
                            # (the reshape-based shifts zero-pad row ends)
                            if strides and d == 1:
                                row_ok &= bool(np.all(rows % strides[0] != strides[0] - 1))
                            if strides and d == -1:
                                row_ok &= bool(np.all(rows % strides[0] != 0))
                        if (
                            len(strides) == 1
                            and strides[0] > 2
                            and B % strides[0] == 0
                            and row_ok
                            and _mg2d_feasible(B, strides[0])
                        ):
                            mg_kind = ("2d", strides[0])
                        else:
                            plan1d = _plan_mg(deltas, B)
                            if plan1d is not None:
                                mg_kind = ("1d", plan1d)
                if mg_kind is None and opts.cg_precond == "mg":
                    raise ValueError(
                        "cg_precond='mg' requires a few-shift-class topology "
                        "(lattice-like multiplier graph); this network does "
                        "not qualify — use 'auto' or 'chebyshev'"
                    )
                if mg_kind is not None:
                    # Shift-preserving aggregation multigrid (2-D geometric
                    # when the class set reveals a lattice, 1-D index
                    # pairing otherwise): ~grid-independent PCG iterations.
                    class_w0 = _shift_class_weights(ed, shift_plan, B)
                    if mg_kind[0] == "2d":
                        precond = _mg2d_preconditioner(
                            class_w0, diag, B, mg_kind[1],
                            overcorrect=opts.mg_overcorrect,
                        )
                    else:
                        precond = _mg_preconditioner(
                            mg_kind[1], class_w0, diag, B,
                            overcorrect=opts.mg_overcorrect,
                        )
                elif opts.cheb_degree > 1 and opts.cg_precond != "jacobi":
                    # Chebyshev-Jacobi polynomial preconditioning: folds
                    # cheb_degree matvecs into one dot-free preconditioner
                    # application, amortizing CG's per-iteration sequential
                    # overhead (see krylov.chebyshev_preconditioner).
                    precond = krylov.chebyshev_preconditioner(
                        matvec, diag, degree=opts.cheb_degree
                    )
                else:
                    precond = lambda v: v / diag  # noqa: E731
                result = krylov.cg(
                    matvec,
                    rhs,
                    precond=precond,
                    rtol=opts.rtol,
                    atol=opts.atol,
                    maxiter=opts.maxiter,
                )
                lam, iters = result.x, result.iters
            residual = jnp.linalg.norm(matvec(lam) - rhs)
            rhs_norm = jnp.linalg.norm(rhs)
        else:
            lam = jnp.zeros(0, dtype=ed.W.dtype)
            iters = jnp.zeros((), dtype=jnp.int32)
            residual = jnp.zeros(())
            rhs_norm = jnp.zeros(())
        if outputs == "blocks":
            q_T, p_T, lam_b = _solution_blocks_T(asm, ed, lam)
            finite = (
                jnp.all(jnp.isfinite(q_T))
                & jnp.all(jnp.isfinite(p_T))
                & jnp.all(jnp.isfinite(lam_b))
            )
            return (
                q_T.astype(out_dt),
                p_T.astype(out_dt),
                lam_b.astype(out_dt),
                iters,
                residual,
                rhs_norm,
                finite,
            )
        x = _schur_back_substitute(asm, ed, lam)
        finite = jnp.all(jnp.isfinite(x))
        return x.astype(out_dt), iters, residual, rhs_norm, finite

    def core(arg0, arg1, start_pbc, end_pbc, cplan=None):
        arg0 = jnp.asarray(arg0, dtype=comp_dt)
        arg1 = jnp.asarray(arg1, dtype=comp_dt)
        start_pbc = jnp.asarray(start_pbc, dtype=comp_dt)
        end_pbc = jnp.asarray(end_pbc, dtype=comp_dt)
        if inputs == "coefficients":
            # On-device coefficient expansion: host→device traffic scales
            # with the compact representation (a scalar, per-edge or
            # per-cell array), not the quadrature grid.
            if (
                asm.flux_degree == 1
                and R_mode in ("scalar", "edge")
                and f_mode in ("scalar", "edge")
            ):
                # Uniform-coefficient fast path: never touch (C,)-sized
                # arrays during condensation (closed forms per edge).
                ed = _make_edge_data_uniform(
                    asm, arg0, arg1, start_pbc, end_pbc, R_mode, f_mode
                )
                return _finish(ed, cplan)
            w = jnp.asarray(asm._quad_weights, dtype=comp_dt)
            phi = jnp.asarray(asm._quad_phi, dtype=comp_dt)
            h = jnp.asarray(mesh.cell_h, dtype=comp_dt)
            cell_scale = None
            if R_mode == "quad":
                cell_mass = (
                    jnp.einsum("cq,q,qi,qj->cij", arg0, w, phi, phi)
                    * h[:, None, None]
                )
            else:
                if R_mode == "scalar":
                    R_cells = arg0[0] * jnp.ones_like(h)
                elif R_mode == "edge":
                    R_cells = arg0[jnp.asarray(mesh.cell_edge)]
                else:  # "cell"
                    R_cells = arg0
                cell_scale = R_cells * h
            if f_mode == "quad":
                cell_f_int = jnp.einsum("cq,q->c", arg1, w) * h
            elif f_mode == "scalar":
                cell_f_int = arg1[0] * h
            elif f_mode == "edge":
                cell_f_int = arg1[jnp.asarray(mesh.cell_edge)] * h
            else:  # "cell"
                cell_f_int = arg1 * h
            if cell_scale is not None:
                # cellwise-constant R, any degree: scalar layout — no
                # (C,2,2) tensor, and for k >= 2 no per-cell condensation
                # Cholesky (fixed condensed constants instead)
                ed = _make_edge_data_scalar(
                    asm, cell_scale, cell_f_int, start_pbc, end_pbc, f_is_zero
                )
            else:
                ed = _make_edge_data(asm, cell_mass, cell_f_int, start_pbc, end_pbc)
        else:
            cell_mass = jnp.asarray(arg0, dtype=comp_dt)
            cell_f_int = jnp.asarray(arg1, dtype=comp_dt)
            ed = _make_edge_data(asm, cell_mass, cell_f_int, start_pbc, end_pbc)
        return _finish(ed, cplan)

    fn = jax.jit(core) if jit else core
    if tree_plan is not None and tree_plan.core_plan is not None:
        # Pass the core-elimination plan as a runtime ARGUMENT (device
        # buffers, transferred once) instead of baking its index arrays
        # into the program as HLO literals — at supernodal scale those
        # constants run to hundreds of MB, bloating compile payloads and
        # duplicating the arrays into every executable.  The public
        # 4-argument executor contract is preserved by closing over the
        # device-resident plan here; callers (Solver, sweeps, bench) are
        # unchanged.  Memoized so a TreeFactorization over the same plan
        # shares the buffers.
        _cplan_dev = _device_core_plan(tree_plan.core_plan)
        _inner_fn = fn

        def fn(arg0, arg1, start_pbc, end_pbc):
            return _inner_fn(arg0, arg1, start_pbc, end_pbc, _cplan_dev)

    try:
        # explicit output contract (see _schur_solve) — never inferred
        # from tuple arity by callers that can know better
        fn.blocks_out = outputs == "blocks"
        if dct_plan is not None:
            # conditioning hint for the λ-residual gate (see _schur_solve)
            fn.kappa_hint = float(max(dct_plan.s, dct_plan.ny)) ** 2
    except AttributeError:  # pragma: no cover - jit wrapper may refuse
        pass
    return fn


def _schur_solve(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: SolverOptions,
    executor=None,
) -> tuple[jnp.ndarray, SolveInfo]:
    if asm.pressure_degree != 0:
        raise ValueError("schur method requires discontinuous (degree-0) pressure")
    if asm.network.has_floating_component():
        raise RuntimeError(
            "Solver did not converge: network has a component with no "
            "boundary node — the system is singular (pressure level "
            "undetermined)"
        )
    if executor is None:
        executor = build_schur_executor(
            asm, opts, jit=False, outputs="blocks", internal_layout=True
        )
    prepare = getattr(executor, "prepare_args", None)
    args = asm.schur_arguments(device=prepare is None)
    if prepare is not None:
        args = prepare(*args)
    out = executor(*args)
    # Output contract from the executor itself (tuple arity alone could
    # silently mis-bind positions if a variant ever changes shape).
    blocks_out = getattr(executor, "blocks_out", None)
    if blocks_out is None:
        blocks_out = len(out) == 7
    elif blocks_out != (len(out) == 7):
        raise RuntimeError(
            f"executor output arity {len(out)} contradicts its declared "
            f"blocks_out={blocks_out} contract"
        )
    if blocks_out:
        # blocks contract: flatten on the host (numpy view-transpose; no
        # device relayout/concat pass — see _solution_blocks_T)
        q_T, p_T, lam, iters, residual, rhs_norm, finite = out
        x = _flatten_blocks_host(
            q_T,
            p_T,
            lam,
            asm.network.edge_color,
            edge_order=getattr(executor, "edge_order", None),
            bif_order=getattr(executor, "bif_order", None),
        )
    else:
        x, iters, residual, rhs_norm, finite = out
    residual = float(residual)
    # Direct-solve convergence floor: a κ-conditioned system's f64
    # residual cannot land below ~κ·ε·‖rhs‖ for ANY backward-stable
    # direct method (host LU hits the same floor) — wide lattices reach
    # it with κ ≈ n_long².  The DCT executors carry the static hint.
    kappa = float(getattr(executor, "kappa_hint", 0.0))
    floor = 64.0 * float(np.finfo(np.float64).eps) * kappa * float(rhs_norm)
    converged = (
        residual <= max(opts.rtol * float(rhs_norm) * 10, opts.atol, 1e-9, floor)
        and bool(finite)
    )
    return x, SolveInfo("schur", int(iters), residual, converged)


def _backsub_from_lambda(
    ed: _EdgeData, lam: jnp.ndarray, k: int, N: int,
    host_bifs: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-edge flux dof vectors (E, k*N+1) and cell pressures (E, N) given
    the multipliers.  Pure per-edge math — reused by the sharded solver with
    device-local edge shards.

    ``host_bifs``: host-static (start_bif, end_bif) copies; when given, the
    λ→edge broadcasts are pattern-matched (see :func:`_structured_take`) —
    the slice/broadcast forms tree numbering admits replace two E-sized
    gathers."""
    E = ed.W.shape[0]
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    lam_s = lam_t = None
    if host_bifs is not None:
        sb, eb = host_bifs
        lam_s = _structured_take(lam, sb)
        lam_t = _structured_take(lam, eb)
    if lam_s is None or lam_t is None:
        lam_pad = jnp.concatenate([lam, jnp.zeros(1, dtype=ed.W.dtype)])
        if lam_s is None:
            lam_s = lam_pad[ed.start_bif]
        if lam_t is None:
            lam_t = lam_pad[ed.end_bif]
    r0 = jnp.where(s_is_bif, lam_s, -ed.start_pbc)
    rN = jnp.where(t_is_bif, -lam_t, ed.end_pbc)

    q0 = (r0 + rN - ed.g) / ed.W

    if ed.ua is not None:
        # Uniform-coefficient closed forms (see _make_edge_data_uniform):
        # q_j = q0 + F j and the pressure prefix sums are quadratic in the
        # cell index — pure broadcast-over-iota, no cumsum, no (C,) input.
        dt = ed.W.dtype
        a, F = ed.ua, ed.uF
        j = jnp.arange(N + 1, dtype=dt)
        q_edge = q0[:, None] + F[:, None] * j[None, :]
        c = jnp.arange(N, dtype=dt)
        p_cells = r0[:, None] - a[:, None] * (
            q0[:, None] * (c + 0.5)[None, :]
            + F[:, None] * (c * c / 2.0 + (3.0 * c + 1.0) / 6.0)[None, :]
        )
        return q_edge, p_cells

    q_chain = q0[:, None] + ed.cumF  # (E, N+1)

    # chain momentum values m_i and pressure back-substitution.
    # Scatter-free: node contributions assembled by shifted concatenation
    # (concats/pads fuse).
    qj, qj1 = q_chain[:, :-1], q_chain[:, 1:]
    if ed.mt is None and k == 1:
        # P1 scalar layout: M_c = a_c * [[1/3, 1/6], [1/6, 1/3]]
        a = ed.rh
        mc0 = a * (qj / 3.0 + qj1 / 6.0)
        mc1 = a * (qj / 6.0 + qj1 / 3.0)
    elif ed.mt is None:
        # degree-k scalar layout: M̃_c = a_c · M̃̂ (fixed condensed matrix)
        Mt, _, _, _ = _condensed_scalar_constants(k)
        a = ed.rh
        # float(): numpy f64 scalars would silently promote f32 arrays
        mc0 = a * (float(Mt[0, 0]) * qj + float(Mt[0, 1]) * qj1)
        mc1 = a * (float(Mt[1, 0]) * qj + float(Mt[1, 1]) * qj1)
    else:
        qc = jnp.stack([qj, qj1], axis=-1)  # (E, N, 2)
        mc = jnp.einsum("enij,enj->eni", ed.mt, qc, precision=_HI)  # (E, N, 2)
        mc0, mc1 = mc[:, :, 0], mc[:, :, 1]
    zero_col = jnp.zeros((E, 1), dtype=ed.W.dtype)
    m_nodes = jnp.concatenate([mc0, zero_col], axis=1) + jnp.concatenate(
        [zero_col, mc1], axis=1
    )  # (E, N+1)
    p_cells = r0[:, None] - jnp.cumsum(m_nodes[:, :-1], axis=1)  # (E, N)

    # full per-edge flux dof vector (E, k*N + 1), built by interleave-reshape
    # rather than strided scatter: along-edge dof k*j+l for cell j, local l.
    if k == 1:
        q_edge = q_chain
    else:
        (Minv_IE,) = ed.interior
        if Minv_IE.ndim == 2:
            # scalar layout: fixed scale-free recovery matrix, one einsum
            q_int = -jnp.einsum(
                "ij,enj->eni", Minv_IE, jnp.stack([qj, qj1], axis=-1),
                precision=_HI,
            )
        else:
            q_int = -jnp.einsum(
                "cij,cj->ci",
                Minv_IE,
                jnp.stack([qj, qj1], axis=-1).reshape(E * N, 2),
                precision=_HI,
            ).reshape(E, N, k - 1)
        cell_block = jnp.concatenate(
            [q_chain[:, :-1, None], q_int], axis=2
        )  # (E, N, k)
        q_edge = jnp.concatenate(
            [cell_block.reshape(E, N * k), q_chain[:, -1:]], axis=1
        )
    return q_edge, p_cells


def _solution_blocks_T(
    asm: _assembly.HydraulicNetworkAssembler, ed: _EdgeData, lam: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Solution as j-major device blocks: ``(q_T (k·N+1, E), p_T (N, E), λ)``.

    The serving output layout: edges run along the minor (contiguous)
    axis.  The edge-major ``(E, m)`` form with a short m ≈ N, and the flat
    global vector, each cost a further relayout pass (tuned on earlier
    hardware; the gain is not measured on the H100).  Both blocks keep
    EDGE-MAJOR columns (edge id order): the global flux dof order wants
    edges color-sorted, but the greedy coloring's permutation is
    unstructured, so the host applies it during flatten (a numpy
    fancy-index on the pulled array) instead of a device gather."""
    mesh = asm.network
    k, N = asm.flux_degree, mesh.N
    host_bifs = (np.asarray(asm._edge_start_bif), np.asarray(asm._edge_end_bif))

    if ed.ua is not None and k == 1:
        # Uniform closed forms, natively j-major.
        dt = ed.W.dtype
        sb, eb = host_bifs
        lam_s = _structured_take(lam, sb)
        lam_t = _structured_take(lam, eb)
        if lam_s is None or lam_t is None:
            lam_pad = jnp.concatenate([lam, jnp.zeros(1, dtype=dt)])
            if lam_s is None:
                lam_s = lam_pad[ed.start_bif]
            if lam_t is None:
                lam_t = lam_pad[ed.end_bif]
        r0 = jnp.where(ed.start_bif >= 0, lam_s, -ed.start_pbc)
        rN = jnp.where(ed.end_bif >= 0, -lam_t, ed.end_pbc)
        q0 = (r0 + rN - ed.g) / ed.W
        a, F = ed.ua, ed.uF
        j = jnp.arange(N + 1, dtype=dt)
        q_T = q0[None, :] + F[None, :] * j[:, None]
        c = jnp.arange(N, dtype=dt)
        p_T = (
            r0[None, :]
            - (a * q0)[None, :] * (c + 0.5)[:, None]
            - (a * F)[None, :] * (c * c / 2.0 + (3.0 * c + 1.0) / 6.0)[:, None]
        )
        return q_T, p_T, lam

    q_edge, p_cells = _backsub_from_lambda(ed, lam, k, N, host_bifs=host_bifs)
    return q_edge.T, p_cells.T, lam


def _flatten_blocks_host(
    q_T: jnp.ndarray,
    p_T: jnp.ndarray,
    lam: jnp.ndarray,
    edge_color: np.ndarray | None = None,
    edge_order: np.ndarray | None = None,
    bif_order: np.ndarray | None = None,
) -> np.ndarray:
    """Host-side global block vector from j-major device blocks.

    ``edge_color``: per-edge colors; when given (and non-trivial), flux
    columns are re-ordered into the color-sorted global dof layout on the
    host — the unstructured permutation that would serialize as a device
    gather.  ``edge_order``/``bif_order``: the executor's internal→public
    maps when the blocked layout is active (``_BlockedExecutor``) —
    composed into the same host fancy-index.  An optional leading batch
    axis (sweeps: (S, m, E) blocks) is carried through."""
    q = np.swapaxes(np.asarray(q_T), -1, -2)  # (..., E, m), executor order
    p = np.swapaxes(np.asarray(p_T), -1, -2)
    lam_np = np.asarray(lam)
    E = q.shape[-2]
    if edge_order is not None:
        inv = np.argsort(edge_order)  # public edge id -> executor row
        p = np.take(p, inv, axis=-2)
    else:
        inv = None
    if edge_color is not None:
        perm = np.lexsort((np.arange(E), np.asarray(edge_color)))
        qidx = perm if inv is None else inv[perm]
        if not np.array_equal(qidx, np.arange(E)):
            q = np.take(q, qidx, axis=-2)
    elif inv is not None:
        q = np.take(q, inv, axis=-2)
    if bif_order is not None:
        lam_pub = np.empty_like(lam_np)
        lam_pub[..., np.asarray(bif_order)] = lam_np
        lam_np = lam_pub
    batch = q.shape[:-2]
    return np.concatenate(
        [q.reshape(*batch, -1), p.reshape(*batch, -1), lam_np], axis=-1
    )


def _schur_back_substitute(
    asm: _assembly.HydraulicNetworkAssembler, ed: _EdgeData, lam: jnp.ndarray
) -> jnp.ndarray:
    """Recover flux and pressure from the multipliers and scatter into the
    global block layout."""
    mesh = asm.network
    k, N = asm.flux_degree, mesh.N
    q_edge, p_cells = _backsub_from_lambda(
        ed, lam, k, N,
        host_bifs=(np.asarray(asm._edge_start_bif), np.asarray(asm._edge_end_bif)),
    )

    # Assemble the global block vector scatter-free: the flux dof layout is
    # exactly "edges sorted by (color, id), each contributing k*N+1
    # consecutive dofs", so a static-permutation gather + concat suffices
    # (pure reorder when the coloring already yields sorted runs).
    E = mesh.num_edges
    perm = np.lexsort((np.arange(E), np.asarray(mesh.edge_color)))
    q_sorted = _structured_take(q_edge, perm)
    if q_sorted is None:
        q_sorted = q_edge[perm]
    x = jnp.concatenate(
        [q_sorted.reshape(-1), p_cells.reshape(-1), lam]
    )
    return x


# ======================================================================
# Continuous-pressure path: per-edge flux elimination → SPD (p, λ) system
# ======================================================================


def _continuous_pressure_solve(
    asm: _assembly.HydraulicNetworkAssembler, opts: SolverOptions
) -> tuple[jnp.ndarray, SolveInfo]:
    """Structure-exploiting solve for continuous pressure (degree >= 1).

    The flux block A is block-diagonal per edge (an (m, m) SPD band with
    m = k·N + 1), so q eliminates edge-by-edge with one batched float64
    Cholesky; the reduced operator T = [B; G] A⁻¹ [Bᵀ, Gᵀ] on (p, −λ) is
    SPD for inf-sup stable pairings and solved with Jacobi-preconditioned
    CG.  All matvecs stay on device (batched triangular solves + sparse
    block applies)."""
    from jax.experimental import sparse as jsparse

    mesh = asm.network
    k, N, E = asm.flux_degree, mesh.N, mesh.num_edges
    m = k * N + 1
    M = mesh.num_edge_colors
    offs = asm.block_offsets
    n_flux = int(offs[M])
    n_red = asm.num_dofs - n_flux  # p and λ dofs

    # --- per-edge dense A blocks from the batched cell masses.
    cell_mass = jnp.asarray(asm._cell_mass).reshape(E, N, k + 1, k + 1)
    li = k * np.arange(N)[:, None] + np.arange(k + 1)[None, :]  # (N, k+1)
    rows = np.broadcast_to(li[:, :, None], (N, k + 1, k + 1)).ravel()
    cols = np.broadcast_to(li[:, None, :], (N, k + 1, k + 1)).ravel()
    A_blocks = (
        jnp.zeros((E, m, m))
        .at[:, jnp.asarray(rows), jnp.asarray(cols)]
        .add(cell_mass.reshape(E, -1))
    )
    chol = jnp.linalg.cholesky(A_blocks)  # (E, m, m), f64

    # --- flux-order permutation: global flux layout is edges sorted by
    # (color, id); per-edge batched ops use edge-id order.
    perm = np.lexsort((np.arange(E), np.asarray(mesh.edge_color)))
    inv_perm = np.argsort(perm)

    def apply_Ainv(v_flux: jnp.ndarray) -> jnp.ndarray:
        ve = v_flux.reshape(E, m)[jnp.asarray(inv_perm)]  # edge-id order
        ue = jax.scipy.linalg.cho_solve((chol, True), ve[:, :, None])[:, :, 0]
        return ue[jnp.asarray(perm)].reshape(-1)

    # --- sparse J = [B; G] (reduced rows × flux cols) from the static COO.
    r_all, c_all = asm._all_rows, asm._all_cols
    vals_all = np.concatenate([np.asarray(asm._cell_mass).ravel(), asm._static_vals])
    sel = (r_all >= n_flux) & (c_all < n_flux)
    J = jsparse.BCOO(
        (
            jnp.asarray(vals_all[sel]),
            jnp.stack(
                [jnp.asarray(r_all[sel] - n_flux), jnp.asarray(c_all[sel])], axis=1
            ),
        ),
        shape=(n_red, n_flux),
    ).sum_duplicates()
    JT = J.T

    b = jnp.asarray(asm._b_host)
    b_q, b_red = b[:n_flux], b[n_flux:]

    def T_apply(z: jnp.ndarray) -> jnp.ndarray:
        return J @ apply_Ainv(JT @ z)

    rhs = b_red - J @ apply_Ainv(b_q)
    # Note row signs: the assembled λ rows are +G with +Gᵀ columns while the
    # flux rows carry −Bᵀ for pressure; substituting q = A⁻¹(b_q + Bᵀp − Gᵀλ)
    # in rows [B; G] gives  [B; G] A⁻¹ [Bᵀ, −Gᵀ] (p, λ) = b_red − JA⁻¹b_q,
    # i.e. T z = rhs with z = (p, −λ) and T = J A⁻¹ Jᵀ (SPD).
    sign = jnp.concatenate(
        [jnp.ones(asm.num_dofs - n_flux - mesh.num_multipliers), -jnp.ones(mesh.num_multipliers)]
    )

    # Jacobi preconditioner from diag(T) ≈ Σ_k J[i,k]² / diag(A)[k].
    A_diag = (
        jnp.zeros(n_flux)
        .at[jnp.asarray(asm._cell_flux_dofs.ravel())]
        .add(jnp.asarray(asm._cell_mass)[
            :, jnp.arange(k + 1), jnp.arange(k + 1)
        ].ravel())
    )
    idx = np.asarray(J.indices)
    Tdiag = (
        jnp.zeros(n_red)
        .at[jnp.asarray(idx[:, 0])]
        .add(J.data**2 / A_diag[jnp.asarray(idx[:, 1])])
    )
    Tdiag = jnp.where(Tdiag > 0, Tdiag, 1.0)

    result = krylov.cg(
        T_apply,
        rhs,
        precond=lambda v: v / Tdiag,
        rtol=opts.rtol if opts.rtol > 0 else 1e-12,
        atol=opts.atol,
        maxiter=opts.maxiter,
    )
    z = result.x
    pl = sign * z  # (p, λ)
    q = apply_Ainv(b_q + JT @ z)
    x = jnp.concatenate([q, pl])
    return x, SolveInfo(
        "schur_p", int(result.iters), float(result.residual), bool(result.converged)
    )


# ======================================================================
# Generic paths: dense / minres / host LU on the assembled system
# ======================================================================


def _to_dense(A) -> jnp.ndarray:
    from jax.experimental import sparse as jsparse

    if isinstance(A, jsparse.BCOO):
        return A.todense()
    return jnp.asarray(A)


def _dense_solve_f64(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dense LU solve in the operands' dtype (float64 by default)."""
    return jnp.linalg.solve(A, b)


def _generic_solve(
    A,
    b: jnp.ndarray,
    asm: _assembly.HydraulicNetworkAssembler,
    method: str,
    opts: SolverOptions,
) -> tuple[jnp.ndarray, SolveInfo]:
    n = asm.num_dofs
    M = asm.network.num_edge_colors
    if method == "dense":
        Ad = _to_dense(A)
        x = _dense_solve_f64(Ad, b)
        res = float(jnp.linalg.norm(Ad @ x - b))
        ok = res <= max(opts.rtol * float(jnp.linalg.norm(b)) * 100, 1e-8)
        return x, SolveInfo("dense", 0, res, bool(ok) and bool(jnp.all(jnp.isfinite(x))))

    if method == "host_lu":
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from jax.experimental import sparse as jsparse

        if isinstance(A, jsparse.BCOO):
            idx = np.asarray(A.indices)
            As = sp.csc_matrix(
                (np.asarray(A.data), (idx[:, 0], idx[:, 1])), shape=(n, n)
            )
        else:
            As = sp.csc_matrix(np.asarray(A))
        x = spla.splu(As.tocsc()).solve(np.asarray(b))
        res = float(np.linalg.norm(As @ x - np.asarray(b)))
        return jnp.asarray(x), SolveInfo("host_lu", 0, res, res <= 1e-6)

    if method == "minres":
        signs = jnp.asarray(
            _symmetrize_signs(asm.block_offsets, M, n), dtype=b.dtype
        )

        def matvec(v):
            return signs * (A @ v)

        # Block-diagonal SPD preconditioner from |diag| of the symmetrized
        # operator (unit fallback where the diagonal vanishes: p and λ rows).
        Adiag = _extract_diagonal(A, n)
        d = jnp.abs(Adiag)
        d = jnp.where(d > 0, d, 1.0)
        result = krylov.minres(
            matvec,
            signs * b,
            precond=lambda v: v / d,
            rtol=opts.rtol,
            atol=opts.atol,
            maxiter=opts.maxiter,
        )
        return result.x, SolveInfo(
            "minres", int(result.iters), float(result.residual), bool(result.converged)
        )

    raise ValueError(f"unknown solver method {method!r}")


def _extract_diagonal(A, n: int) -> jnp.ndarray:
    from jax.experimental import sparse as jsparse

    if isinstance(A, jsparse.BCOO):
        idx = A.indices
        on_diag = idx[:, 0] == idx[:, 1]
        return jnp.zeros(n, dtype=A.data.dtype).at[idx[:, 0]].add(
            jnp.where(on_diag, A.data, 0.0)
        )
    return jnp.diagonal(jnp.asarray(A))
