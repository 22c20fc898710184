"""The exact-sum oracle of B2's float64 Kahan sums
(``kernels/ref.py:tsmttsm_exact_entries``) and ``chip_smoke.py``'s check
built on it (``_require_exact_kahan``), on the CPU.

The oracle is held against sums of rationals (``fractions.Fraction``,
exact): its ``hi + lo`` within 4 units of 2^-106 of sum |terms|, and
``hi`` the correctly rounded sum.  The check is held against emulations
of the DMMA instance's order (8-row groups, each folded into the running
sum with compensation): the compensated order passes, and the same order
without its folds or with the compensation's sign flipped fails, as the
float64 plain version (whose own rounding is n units) could not tell.
"""
from fractions import Fraction
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import tsmttsm_exact_entries

REPO = Path(__file__).resolve().parents[1]


def _operands(n, m, k, seed, spread=0.0):
    g = torch.Generator().manual_seed(seed)
    V = torch.randn(n, m, generator=g, dtype=torch.float64)
    V = V * torch.exp(spread * torch.randn(n, m, generator=g,
                                           dtype=torch.float64))
    W = torch.randn(n, k, generator=g, dtype=torch.float64)
    return V, W


def _fraction_sum(a, b):
    return sum((Fraction(x) * Fraction(y) for x, y in zip(a, b)), Fraction(0))


@pytest.mark.parametrize("spread", [0.0, 8.0], ids=["normal", "spread"])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 1000, 4097])
def test_exact_entries_match_rational_sums(n, spread):
    """hi + lo within 4 units of 2^-106 of sum |terms| of the rational sum,
    and hi that sum rounded to the nearest double, on operands of one
    scale and of scales spread over e^(+-8 sigma)."""
    V, W = _operands(n, 5, 3, seed=n + int(spread), spread=spread)
    rows, cols = [0, 4, 2, 1, 3], [0, 2, 1, 1, 0]
    hi, lo = tsmttsm_exact_entries(V, W, rows, cols)
    assert hi.shape == lo.shape == (5,)
    for e, (i, j) in enumerate(zip(rows, cols)):
        a, b = V[:, i].tolist(), W[:, j].tolist()
        exact = _fraction_sum(a, b)
        got = Fraction(float(hi[e])) + Fraction(float(lo[e]))
        scale = sum(abs(x * y) for x, y in zip(a, b))
        assert abs(float(got - exact)) <= 4 * 2.0 ** -106 * scale
        assert float(hi[e]) == float(exact)


def test_exact_entries_in_chunks_equal_one_pass(monkeypatch):
    """Entries formed a few at a time (EXACT_CHUNK values an operand) are
    the entries formed all at once, bit for bit."""
    V, W = _operands(300, 6, 4, seed=3)
    rows, cols = [0, 5, 3, 2, 1, 4, 0], [3, 0, 1, 2, 2, 3, 0]
    whole = tsmttsm_exact_entries(V, W, rows, cols)
    monkeypatch.setattr(ref, "EXACT_CHUNK", 600)       # two entries a pass
    parts = tsmttsm_exact_entries(V, W, rows, cols)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_exact_entries_take_float64_only():
    V, W = _operands(10, 2, 2, seed=0)
    with pytest.raises(TypeError):
        tsmttsm_exact_entries(V.float(), W, [0], [0])


def _emulated_kahan(V, W, fold=True, sign=1.0):
    """V^T W in the DMMA instance's Kahan order for one row block: each
    8-row group's products added to the accumulator -c, then u = s + y,
    -c = y - (u - s), s = u.  ``fold=False`` adds the groups plainly (the
    instance without its folds), ``sign=-1`` flips the compensation."""
    n, m = V.shape
    s = torch.zeros(m, W.shape[1], dtype=torch.float64)
    c = torch.zeros_like(s)
    for g0 in range(0, n, 8):
        y = c + V[g0:g0 + 8].T @ W[g0:g0 + 8]
        if not fold:
            s = s + (y - c)
            continue
        u = s + y
        c = sign * (y - (u - s))
        s = u
    return s


def test_exact_check_catches_a_kernel_that_does_not_compensate(monkeypatch):
    """chip_smoke.py's exact check (held as on the card) passes the
    compensated order and fails the same order without its folds and
    with the compensation's sign flipped; the plain sum is V^T W in the
    same 8-row groups, added plainly."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cuda")  # require, as there
    monkeypatch.setattr(chip_smoke, "kahan_depth",
                        lambda n, m, k, dt, values=None: 14.0)
    V, W = _operands(1 << 14, 8, 8, seed=30)
    plain = _emulated_kahan(V, W, fold=False)
    g = torch.Generator().manual_seed(1)
    line = chip_smoke._require_exact_kahan(V, W, _emulated_kahan(V, W),
                                           plain, g, "compensated")
    assert "entries summed exactly" in line
    for fault in (_emulated_kahan(V, W, fold=False),
                  _emulated_kahan(V, W, sign=-1.0)):
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke._require_exact_kahan(V, W, fault, plain, g, "fault")
