"""Static-pattern CSR assembly (the ``MatSetValues`` replacement).

Replaces the role of PETSc's ``MatSetValues`` insertion loop in the
reference (reference ``assembly.py:355-357`` drives per-cell C kernels that
scatter element matrices into an AIJ matrix): here the sparsity pattern is
STATIC (host-precomputed once per mesh/degree), so assembly is a
permute + duplicate-fold of the batched element-matrix values into unique
CSR slots with no scatter.  The default ``gather`` method folds
duplicates through a host-precomputed ``(nnz, max_dup)`` gather matrix,
exactly in float64 and in a fixed summation order.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["CSRPattern", "build_csr_pattern", "make_csr_assembler"]


class CSRPattern:
    """Static CSR sparsity + duplicate-folding plan for a COO stream.

    Attributes:
        indptr: (nrows+1,) CSR row pointers.
        indices: (nnz,) CSR column indices.
        perm: (nraw,) permutation sorting the raw COO stream by (row, col).
        segment_ids: (nraw,) unique-slot id of each sorted raw entry.
        shape: Matrix shape.
    """

    def __init__(self, rows: np.ndarray, cols: np.ndarray, shape: tuple[int, int]):
        nraw = rows.shape[0]
        order = np.lexsort((cols, rows))
        r_sorted, c_sorted = rows[order], cols[order]
        new_slot = np.empty(nraw, dtype=bool)
        new_slot[0] = True
        new_slot[1:] = (r_sorted[1:] != r_sorted[:-1]) | (c_sorted[1:] != c_sorted[:-1])
        segment_ids = np.cumsum(new_slot) - 1
        nnz = int(segment_ids[-1]) + 1
        u_rows = r_sorted[new_slot]
        u_cols = c_sorted[new_slot]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, u_rows + 1, 1)
        np.cumsum(indptr, out=indptr)

        self.shape = shape
        self.perm = order.astype(np.int32)
        self.segment_ids = segment_ids.astype(np.int32)
        self.indptr = indptr
        self.indices = u_cols.astype(np.int32)
        self.nnz = nnz
        self.nraw = nraw


def build_csr_pattern(rows: np.ndarray, cols: np.ndarray, shape) -> CSRPattern:
    return CSRPattern(np.asarray(rows), np.asarray(cols), tuple(shape))


def _segment_sum_fallback(pattern: CSRPattern):
    perm = jnp.asarray(pattern.perm)
    seg = jnp.asarray(pattern.segment_ids)
    nnz = pattern.nnz

    def assemble(values: jnp.ndarray) -> jnp.ndarray:
        return jax.ops.segment_sum(
            values[perm], seg, num_segments=nnz, indices_are_sorted=True
        )

    return assemble


def make_gather_assembler(pattern: CSRPattern):
    """Exact float64 duplicate folding with NO scatter: each CSR slot gathers
    its (boundedly many) duplicate contributions through a host-precomputed
    ``(nnz, max_dup)`` index matrix and reduces along the short axis.
    The summation order is fixed by the plan, so repeated assemblies are
    bit-identical."""
    nnz, nraw = pattern.nnz, pattern.nraw
    counts = np.bincount(pattern.segment_ids, minlength=nnz)
    max_dup = int(counts.max()) if nnz else 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    idx = np.minimum(
        offsets[:-1, None] + np.arange(max_dup)[None, :], nraw
    )  # out-of-range rows point at a zero pad slot
    mask = np.arange(max_dup)[None, :] < counts[:, None]
    idx = np.where(mask, idx, nraw)

    perm = jnp.asarray(pattern.perm)
    idx_dev = jnp.asarray(idx)

    def assemble(values: jnp.ndarray) -> jnp.ndarray:
        sorted_vals = jnp.concatenate(
            [values[perm], jnp.zeros(1, dtype=values.dtype)]
        )
        return jnp.sum(sorted_vals[idx_dev], axis=1)

    return assemble


def make_csr_assembler(pattern: CSRPattern, method: str = "auto"):
    """Build ``assemble(values) -> csr_data`` for a fixed sparsity pattern.

    Methods:
        ``"gather"``  — exact f64 gather-matrix fold (default): each CSR
            slot gathers its boundedly-many duplicates and reduces along
            the short axis.
        ``"segment"`` — ``jax.ops.segment_sum`` reference implementation.
        ``"auto"``    — gather.
    """
    if method == "auto":
        method = "gather"
    if method == "gather":
        return make_gather_assembler(pattern)
    if method == "segment":
        return _segment_sum_fallback(pattern)
    raise ValueError(f"unknown csr assembler method {method!r}")
