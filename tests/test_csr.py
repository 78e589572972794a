"""CSR assembly write path: pattern planning, duplicate folding (gather /
segment), CSRMatrix algebra."""

import numpy as np
import pytest

import jax.numpy as jnp

from networks_fenicsx_tpu import HydraulicNetworkAssembler, NetworkMesh, network_generation
from networks_fenicsx_tpu.ops import csr_assembly as pa


def _random_coo(n=257, nraw=6000, seed=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nraw)
    cols = rng.integers(0, n, nraw)
    vals = rng.standard_normal(nraw)
    return rows, cols, vals, n


def test_pattern_matches_scipy():
    import scipy.sparse as sp

    rows, cols, vals, n = _random_coo()
    pat = pa.build_csr_pattern(rows, cols, (n, n))
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    np.testing.assert_array_equal(pat.indptr, S.indptr)
    np.testing.assert_array_equal(pat.indices, S.indices)


@pytest.mark.parametrize("method", ["gather", "segment"])
def test_fold_exact(method):
    import scipy.sparse as sp

    rows, cols, vals, n = _random_coo()
    pat = pa.build_csr_pattern(rows, cols, (n, n))
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    data = pa.make_csr_assembler(pat, method=method)(jnp.asarray(vals))
    np.testing.assert_allclose(np.asarray(data), S.data, atol=1e-13)


@pytest.mark.parametrize("method", ["pallas", "scatter"])
def test_unknown_method_raises(method):
    """Only the gather fold and the segment_sum reference exist; any other
    name must fail loudly, not silently fall back."""
    rows, cols, vals, n = _random_coo(n=150, nraw=3000)
    pat = pa.build_csr_pattern(rows, cols, (n, n))
    with pytest.raises(ValueError, match="unknown csr assembler method"):
        pa.make_csr_assembler(pat, method=method)


def test_assembler_csr_kind():
    G = network_generation.make_tree(3, 1, 2)
    mesh = NetworkMesh(G, N=3)
    asm = HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    A_csr, b = asm.assemble(kind="csr")
    A_dense, _ = asm.assemble(kind="dense")
    np.testing.assert_allclose(np.asarray(A_csr.todense()), np.asarray(A_dense), atol=1e-13)
    v = np.linspace(-1, 1, asm.num_dofs)
    np.testing.assert_allclose(
        np.asarray(A_csr @ jnp.asarray(v)), np.asarray(A_dense) @ v, atol=1e-12
    )
    S = A_csr.to_scipy()
    np.testing.assert_allclose(S.toarray(), np.asarray(A_dense), atol=1e-13)
