"""Dense f64 kernels vs NumPy: the dense LU solve, the bordered
capacitance inverse of the lattice solve, the shared scaled Cholesky (and
its singularity gate) and the multifrontal front inverse."""

import numpy as np
import pytest

import jax.numpy as jnp

from networks_fenicsx_tpu import HydraulicNetworkAssembler, NetworkMesh
from networks_fenicsx_tpu import solver as S
from networks_fenicsx_tpu.network_generation import make_grid
from networks_fenicsx_tpu.ops.scaled_cholesky import (
    scaled_cholesky_factor,
    scaled_cholesky_solve,
)
from networks_fenicsx_tpu.ops.multifrontal import chol_inverse_batched


def _laplacian(n: int, grounded: bool, seed: int = 0) -> np.ndarray:
    """Weighted ring-plus-chords graph Laplacian; ``grounded`` adds a
    boundary (diagonal shift at node 0), otherwise it is singular."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pairs = np.concatenate([np.stack([i, (i + 1) % n], 1), np.stack([i, (i + 7) % n], 1)])
    w = rng.uniform(0.5, 3.0, len(pairs))
    L = np.zeros((n, n))
    np.add.at(L, (pairs[:, 0], pairs[:, 0]), w)
    np.add.at(L, (pairs[:, 1], pairs[:, 1]), w)
    np.add.at(L, (pairs[:, 0], pairs[:, 1]), -w)
    np.add.at(L, (pairs[:, 1], pairs[:, 0]), -w)
    if grounded:
        L[0, 0] += 1.0
    return L


def test_dense_solve_f64_matches_numpy():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((60, 60)) + 60 * np.eye(60)
    b = rng.standard_normal(60)
    x = S._dense_solve_f64(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), rtol=1e-13, atol=1e-14)


def test_bordered_capacitance_inverse_matches_numpy():
    mesh = NetworkMesh(make_grid(7, 5, arrays=True), N=1)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=1.5)
    plan = S.build_grid_factorization(asm)._plan.dct
    r = int(plan.stub_rows.size)
    assert r > 0
    w_r = jnp.asarray(np.random.default_rng(2).uniform(0.5, 2.0, r))
    state = S._dct_capacitance_factor(plan, 0.7, 0.9, w_r, jnp.float64)
    M = np.asarray(S._bordered_capacitance(plan, state["g"], w_r))
    v = np.random.default_rng(3).standard_normal(r + 1)
    assert state["Minv"].dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(state["Minv"] @ v), np.linalg.solve(M, v),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n", [40, 300])
def test_scaled_cholesky_matches_numpy(n):
    L = _laplacian(n, grounded=True)
    b = np.random.default_rng(n).standard_normal(n)
    x = scaled_cholesky_solve(scaled_cholesky_factor(jnp.asarray(L)), jnp.asarray(b))
    ref = np.linalg.solve(L, b)
    assert np.max(np.abs(np.asarray(x) - ref)) / np.abs(ref).max() < 1e-11


def test_scaled_cholesky_pivot_gate_nan_on_floating_network():
    """A boundary-free network's Laplacian is singular: the gate trips and
    the solve is NaN everywhere (callers' finiteness guards then fail)."""
    L = _laplacian(50, grounded=False)
    state = scaled_cholesky_factor(jnp.asarray(L))
    assert not bool(state["ok"])
    x = scaled_cholesky_solve(state, jnp.ones(50))
    assert np.all(np.isnan(np.asarray(x)))


@pytest.mark.parametrize("grounded", [True, False], ids=["grounded", "floating"])
def test_front_inverse_on_network_laplacians(grounded):
    """The multifrontal front inverse on Laplacian fronts: inv(chol(L)) at
    f32 accuracy when grounded; non-finite (the pivot check's trigger) for
    a boundary-free, singular front."""
    A = np.stack([_laplacian(40, grounded, seed=s) for s in range(3)]).astype(np.float32)
    Li = np.asarray(chol_inverse_batched(jnp.asarray(A)), np.float64)
    if not grounded:
        assert not np.all(np.isfinite(Li))
        return
    for i in range(3):
        ref = np.linalg.inv(np.linalg.cholesky(A[i].astype(np.float64)))
        assert np.max(np.abs(Li[i] - ref)) / np.abs(ref).max() < 1e-3
        assert np.allclose(np.triu(Li[i], 1), 0.0)
