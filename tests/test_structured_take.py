"""Trace-time structured-index pattern matching (solver._structured_take).

These host-side matchers replace device gathers with slices/broadcasts when
the static index map allows; a wrong match would silently corrupt every
solve, so each pattern and each fallback is pinned against numpy here.
"""

import numpy as np
import pytest

from networks_fenicsx_tpu.solver import (
    _match_repeat,
    _match_slice,
    _segsum_sorted,
    _structured_take,
)


def _expected_take(vec, idx):
    out = np.where(idx >= 0, np.asarray(vec)[np.minimum(idx, len(vec) - 1)], 0.0)
    return out


@pytest.mark.parametrize(
    "idx",
    [
        np.arange(7),                      # identity
        np.arange(3, 11),                  # offset slice
        np.repeat(np.arange(5), 2),        # uniform fanout K=2
        np.repeat(np.arange(4), 3) + 2,    # fanout K=3, offset
        np.repeat(np.arange(5), 2)[1:],    # phase-shifted fanout (partial head)
        np.repeat(np.arange(5), 2)[:-1],   # partial tail
        np.concatenate([[-1], np.repeat(np.arange(6), 2)]),   # boundary head
        np.concatenate([np.arange(6), -np.ones(4, np.int64)]),  # boundary tail
        np.concatenate([-np.ones(2, np.int64), np.arange(5), -np.ones(3, np.int64)]),
        np.array([0, 0, 0, 1, 1]),         # partial tail run of an affine map
        np.array([0, 0, 1, 1, 1, 2, 2]),   # partial head+tail runs
    ],
)
def test_structured_take_matches_numpy(idx):
    vec = np.linspace(1.0, 2.0, int(idx.max()) + 3)
    got = _structured_take(vec, idx)
    assert got is not None, f"pattern should match: {idx}"
    np.testing.assert_array_equal(np.asarray(got), _expected_take(vec, idx))


def test_structured_take_multichannel():
    idx = np.repeat(np.arange(4), 2)
    vec = np.arange(12.0).reshape(6, 2)
    got = _structured_take(vec, idx)
    assert got is not None
    np.testing.assert_array_equal(np.asarray(got), vec[idx])


@pytest.mark.parametrize(
    "idx",
    [
        np.array([0, 2, 1, 3]),            # permutation, not monotone
        np.array([0, 0, 0, 1, 1, 2, 2, 2]),  # ragged interior run
        np.array([0, -1, 1, -1, 2, -1, 3, -1, 4, -1, 5, -1, 6, -1]),  # >6 runs
    ],
)
def test_structured_take_falls_back(idx):
    vec = np.linspace(0.0, 1.0, int(idx.max()) + 2)
    assert _structured_take(vec, idx) is None


def test_structured_take_empty():
    got = _structured_take(np.ones(3), np.empty(0, np.int64))
    assert np.asarray(got).shape == (0,)


def test_match_slice_and_repeat():
    assert _match_slice(np.arange(4) + 5) == 5
    assert _match_slice(np.array([1, 3])) is None
    assert _match_repeat(np.array([2, 2, 3, 3, 4])) == (2, 2, 0, 3)
    assert _match_repeat(np.array([2, 3, 3, 4, 4])) == (2, 2, 1, 3)
    assert _match_repeat(np.array([0, 1, 2])) is None      # K=1 is a slice
    assert _match_repeat(np.array([0, 0, 2])) is None      # gap
    # a short FINAL run is an affine partial tail (i//3), not ragged
    assert _match_repeat(np.array([0, 0, 0, 1, 1])) == (0, 3, 0, 2)
    assert _match_repeat(np.array([0, 0, 0, 1, 1, 2, 2, 2])) is None  # ragged


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("structured", [True, False])
def test_segsum_with_sel_matches_naive(seed, structured):
    rng = np.random.default_rng(seed)
    S, K = 13, 3
    if structured:
        # contiguous uniform layout -> reshape path
        sel = np.arange(S * K)
        seg = np.repeat(np.arange(S), K)
    else:
        n = 29
        sel = rng.permutation(40)[:n]
        seg = np.sort(rng.integers(0, S, n))
    vals = rng.standard_normal(int(sel.max()) + 1)
    got = np.asarray(_segsum_sorted(vals, seg, S, sel=sel))
    want = np.zeros(S)
    np.add.at(want, seg, vals[sel])
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def test_structured_take_stride():
    vec = np.linspace(0.0, 1.0, 40)
    for idx in (np.arange(0, 30, 3), 5 + 2 * np.arange(10),
                np.concatenate([-np.ones(2, np.int64), 4 + 5 * np.arange(7)])):
        got = _structured_take(vec, idx)
        assert got is not None
        np.testing.assert_array_equal(np.asarray(got), _expected_take(vec, idx))
    # non-uniform stride still falls back
    assert _structured_take(vec, np.array([0, 2, 5, 9])) is None
