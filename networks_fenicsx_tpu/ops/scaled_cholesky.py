"""Shared dense SPD solve: Jacobi-scaled Cholesky with a pivot gate.

Every dense SPD tail in the solver — the dense Schur path, the dense cycle
core of the tree elimination, and the dense remainder of the sparse core
elimination — factorises the Jacobi-scaled matrix in the compute dtype
(float64 by default) with one Cholesky.  The scaled matrix has unit
diagonal; the pivot gate is the MUMPS zero-pivot analog (a boundary-free
network component makes the Laplacian singular — its pivots collapse or go
NaN, and the solve returns NaN so callers fail loudly, matching the
reference's ``ksp_error_if_not_converged``, reference ``solver.py:64``).

One implementation so the pivot threshold cannot drift between the call
sites.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["scaled_cholesky_factor", "scaled_cholesky_solve"]

# Relative pivot collapse threshold (the singularity gate).
_PIVOT_RTOL = 1e-7


def scaled_cholesky_factor(Lc: jnp.ndarray) -> dict:
    """Factor an SPD matrix: Jacobi scaling + Cholesky + pivot gate.

    Returns a device pytree ``{"chol", "dscale", "ok"}`` consumed by
    :func:`scaled_cholesky_solve`; ``ok`` is False when the pivots signal
    a (numerically) singular matrix.
    """
    dscale = jnp.sqrt(jnp.diagonal(Lc))
    chol = jnp.linalg.cholesky((Lc / dscale[:, None]) / dscale[None, :])
    piv = jnp.diagonal(chol)
    ok = jnp.all(jnp.isfinite(piv)) & (jnp.min(piv) > _PIVOT_RTOL * jnp.max(piv))
    return {"chol": chol, "dscale": dscale, "ok": ok}


def scaled_cholesky_solve(state: dict, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve against a :func:`scaled_cholesky_factor` state for one rhs.

    Returns NaN everywhere when the factor's pivot gate tripped (singular
    system).
    """
    chol, dscale = state["chol"], state["dscale"]
    x = jax.scipy.linalg.cho_solve((chol, True), rhs / dscale) / dscale
    return jnp.where(state["ok"], x, jnp.nan)
