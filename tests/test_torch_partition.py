"""The port's partitions (``repro_torch.core.partition``) against the JAX
package's, bit for bit — every function over weights, skews, ``align``
and seeds — and the counterparts of ``tests/test_partition.py``
(weighted partitions, the covering property, RCM, coloring)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import partition as jpt
from repro_torch.core import partition as pt
from repro_torch.matrices import banded_random, laplace2d

WEIGHTS = [[1, 1, 1, 1], [1.0, 2.75], [1, 1.7, 0.4], [1000.0, 1.0, 1.0, 1.0],
           [50, 150, 150], [0.1, 10, 0.1, 10, 3], [1.0], [3.0, 1e-3, 2.0]]
ALIGNS = [1, 4, 32]


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)
        assert all(type(x) is type(y) for p, q in zip(a, b)
                   for x, y in zip(p, q))


def _rowlen(seed, n, skew):
    rng = np.random.default_rng(seed)
    rl = rng.integers(0, 8, n)
    rl[: n // 10] += skew
    return rl


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("w", WEIGHTS, ids=str)
@pytest.mark.parametrize("n", [0, 7, 100, 997, 12345])
def test_row_partitions_match_reference(n, w, align):
    for name in ("weighted_row_partition", "apportioned_row_partition"):
        _same(getattr(pt, name)(n, w, align=align),
              getattr(jpt, name)(n, w, align=align))


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("w", WEIGHTS, ids=str)
@pytest.mark.parametrize("skew,seed", [(0, 0), (50, 1), (500, 2)])
def test_nnz_partitions_match_reference(w, align, skew, seed):
    for n in (5, 300, 2049):
        rl = _rowlen(seed, n, skew)
        for name in ("weighted_nnz_partition", "apportioned_nnz_partition"):
            _same(getattr(pt, name)(rl, w, align=align),
                  getattr(jpt, name)(rl, w, align=align))
    zero = np.zeros(64, np.int64)          # no nonzeros: the row fallback
    _same(pt.apportioned_nnz_partition(zero, w, align=align),
          jpt.apportioned_nnz_partition(zero, w, align=align))


@pytest.mark.parametrize("cnt,nblocks", [([0, 5, 0], 5), ([3, 0, 0, 0], 3),
                                         ([0, 0], 1), ([7, 1, 0], 8)])
def test_steal_for_empty_matches_reference(cnt, nblocks):
    _same(pt._steal_for_empty(np.array(cnt, np.int64), nblocks),
          jpt._steal_for_empty(np.array(cnt, np.int64), nblocks))


@pytest.mark.parametrize("name", ["weighted_row_partition",
                                  "apportioned_row_partition"])
def test_bad_weights_raise_like_reference(name):
    for mod in (pt, jpt):
        with pytest.raises(ValueError, match="positive"):
            getattr(mod, name)(10, [1, -1])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gen", ["banded", "laplace2d", "random"])
def test_orderings_match_reference(gen, seed):
    rng = np.random.default_rng(seed)
    if gen == "banded":
        r, c, _, n = banded_random(200, bw=5, density=0.7, seed=seed,
                                   sym=True)
        p = rng.permutation(n)
        r, c = p[r], p[c]
    elif gen == "laplace2d":
        r, c, _, n = laplace2d(9 + seed)
    else:                               # disconnected, with isolated rows
        n = 150
        r, c = rng.integers(0, n // 2, 120), rng.integers(0, n // 2, 120)
    _same(pt.rcm_permutation(r, c, n), jpt.rcm_permutation(r, c, n))
    _same(pt.greedy_coloring(r, c, n), jpt.greedy_coloring(r, c, n))
    assert pt.bandwidth(r, c) == jpt.bandwidth(r, c)
    assert pt.bandwidth([], []) == jpt.bandwidth([], []) == 0


# ------------------------------------------- counterparts of test_partition
class TestWeightedPartition:
    def test_equal_weights(self):
        ranges = pt.weighted_row_partition(100, [1, 1, 1, 1])
        assert ranges == [(0, 25), (25, 50), (50, 75), (75, 100)]

    def test_proportional(self):
        """Paper section 4.1: CPU:GPU 1:2.75 bandwidth split."""
        ranges = pt.weighted_row_partition(1000, [1.0, 2.75])
        s0 = ranges[0][1] - ranges[0][0]
        s1 = ranges[1][1] - ranges[1][0]
        assert abs(s1 / s0 - 2.75) < 0.1

    def test_alignment(self):
        ranges = pt.weighted_row_partition(1000, [1, 1.7, 0.4], align=32)
        for s, e in ranges[:-1]:
            assert s % 32 == 0

    def test_nnz_partition_balances_nonzeros(self):
        rowlen = np.concatenate([np.full(100, 50), np.full(900, 5)])
        ranges = pt.weighted_nnz_partition(rowlen, [1, 1])
        nnz = [rowlen[s:e].sum() for s, e in ranges]
        assert abs(nnz[0] - nnz[1]) / sum(nnz) < 0.05

    def test_bad_weights(self):
        with pytest.raises(ValueError):
            pt.weighted_row_partition(10, [1, -1])


@settings(max_examples=30, deadline=None)
@given(n=st.integers(10, 5000),
       ws=st.lists(st.floats(0.1, 10), min_size=1, max_size=8))
def test_property_partition_covers(n, ws):
    """Property: ranges tile [0, n) exactly, in order, as the reference's."""
    ranges = pt.weighted_row_partition(n, ws)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (s0, e0), (s1, e1) in zip(ranges, ranges[1:]):
        assert e0 == s1
        assert s0 <= e0
    assert ranges == jpt.weighted_row_partition(n, ws)


class TestRCM:
    def test_reduces_bandwidth(self):
        rng = np.random.default_rng(0)
        n = 300
        r, c, v, _ = banded_random(n, bw=4, density=1.0, seed=1, sym=True)
        p = rng.permutation(n)
        rp, cp = p[r], p[c]
        bw0 = pt.bandwidth(rp, cp)
        perm = pt.rcm_permutation(rp, cp, n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        bw1 = pt.bandwidth(inv[rp], inv[cp])
        assert bw1 < bw0

    def test_is_permutation(self):
        r, c, v, n = laplace2d(8)
        perm = pt.rcm_permutation(r, c, n)
        assert sorted(perm.tolist()) == list(range(n))


class TestColoring:
    def test_valid_coloring(self):
        r, c, v, n = laplace2d(6)
        color = pt.greedy_coloring(r, c, n)
        off = r != c
        assert (color[r[off]] != color[c[off]]).all()
        # 2D laplacian is bipartite: greedy should need exactly 2 colors
        assert color.max() == 1
