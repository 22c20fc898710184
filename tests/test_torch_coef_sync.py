"""Coefficients reach the port's kernels without a host sync.

A number goes to a kernel by value, a tensor on the card through its
pointer, and neither is read on the host
(``repro_torch.kernels.sellcs_spmv.coefficient_arg``, used by B1's
alpha, beta, delta, eta and gamma, B2's and B3's alpha and beta, and
B5's a and b).  The CPU tests check the hand-over's rules; the
``gpu``-marked tests run the calls under
``torch.cuda.set_sync_debug_mode("error")``, where a synchronising call
raises, and hold B5 past one thread block's slots (bw = 257 and 512, the
slot tiles along grid.y) against its plain version, bit-equal from call
to call.  This file imports no JAX, so its card tests run where JAX is
missing.
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import SpmvOpts, execution, from_coo
from repro_torch.kernels import fused_update
from repro_torch.kernels.ops import (fused_axpby_dots, sellcs_spmv, tsmm,
                                     tsmttsm)
from repro_torch.kernels.ref import fused_axpby_dots_ref
from repro_torch.kernels.sellcs_spmv import coefficient_arg
from repro_torch.matrices import laplace3d
from repro_torch.solvers import make_operator

# the package exports functions of these names, which hide the modules
chebfd_mod = importlib.import_module("repro_torch.solvers.chebfd")
kpm_mod = importlib.import_module("repro_torch.solvers.kpm")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


# ------------------------------------------------------------- on the host
@pytest.mark.parametrize("v", [0.5, 3, np.float32(0.25), torch.tensor(-2.0),
                               torch.tensor([1.5])],
                         ids=["float", "int", "numpy", "0-d", "one value"])
def test_a_scalar_goes_by_value(v):
    arg = coefficient_arg("f", "a", v, torch.float64, "cpu", width=4)
    assert arg.values is None and arg.ptr is None and arg.width == 0
    assert arg.re == float(np.asarray(v).reshape(())) and arg.im == 0.0


def test_a_complex_scalar_goes_by_value_for_a_complex_dtype():
    arg = coefficient_arg("f", "a", 0.5 - 2j, torch.complex64, "cpu")
    assert (arg.re, arg.im, arg.values) == (0.5, -2.0, None)
    with pytest.raises(TypeError, match="is real"):
        coefficient_arg("f", "a", 0.5 - 2j, torch.float64, "cpu")
    with pytest.raises(TypeError, match="is real"):
        coefficient_arg("f", "a", np.array([1j, 2.0]), torch.float64, "cpu",
                        width=2)


@pytest.mark.parametrize("v", [torch.arange(3.0), np.arange(3.0),
                               [0.0, 1.0, 2.0]],
                         ids=["tensor", "numpy", "list"])
def test_per_column_values_go_as_a_tensor_of_the_compute_dtype(v):
    arg = coefficient_arg("f", "a", v, torch.float64, "cpu", width=3)
    assert arg.values.dtype == torch.float64 and arg.width == 3
    assert arg.values.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match=r"scalar or \(4,\)"):
        coefficient_arg("f", "a", v, torch.float64, "cpu", width=4)


def test_float64_numbers_keep_their_bits():
    """A Python float is handed over as a double (no float32 tensor on
    the way, as ``torch.as_tensor`` of a list would make)."""
    arg = coefficient_arg("f", "a", [0.1, 0.2], torch.float64, "cpu",
                          width=2)
    assert arg.values.tolist() == [0.1, 0.2]
    assert coefficient_arg("f", "a", 0.1, torch.float64, "cpu").re == 0.1


# ------------------------------------------------------------ on the card
@pytest.fixture(scope="module")
def card_matrices():
    need_card()
    r, c, v, n = laplace3d(24)
    A64 = from_coo(r, c, v, (n, n), C=32, sigma=64, dtype=np.float64,
                   device="cuda")
    A16 = from_coo(r, c, v, (n, n), C=32, sigma=64, dtype=np.float32,
                   store_dtype=torch.bfloat16, device="cuda")
    return A64, A16


@contextlib.contextmanager
def _no_sync():
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["b5 numbers", "b5 complex numbers",
                                  "b5 card tensors", "b5 complex card tensors",
                                  "b1 gamma", "b1 card alpha",
                                  "chebfd filter step", "kpm moment step",
                                  "tsmm card alpha", "tsmttsm card beta"])
def test_no_host_sync_on_card(case, card_matrices):
    """Each call, after one call that loads its kernel, makes no
    synchronising call (torch's sync debug mode raises on one)."""
    A64, A16 = card_matrices
    n = A64.nrows_pad
    g = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=g, dtype=dtype, device="cuda")

    dots = dict(dot_yy=True, dot_xy=True, dot_xx=True)
    x, y = randn(n, 4), randn(n, 4)
    xc, yc = (randn(n, 4, dtype=torch.complex128) for _ in range(2))
    V, X = randn(n, 8), randn(8, 8)
    a4, ac4 = randn(4), randn(4, dtype=torch.complex128)
    s0, s1, gam = randn(()), randn(()), randn(8)
    b0 = torch.full((), -0.5, dtype=torch.float64, device="cuda")
    bc0 = torch.full((), 0.25j, dtype=torch.complex128, device="cuda")
    op64, op16 = make_operator(A64), make_operator(A16)
    w = randn(n, 4, dtype=torch.float32)
    mu = torch.ones(4, dtype=torch.float32, device="cuda")
    calls = {
        "b5 numbers": lambda: fused_axpby_dots(x, y, 0.75, -0.5, **dots),
        "b5 complex numbers": lambda: fused_axpby_dots(
            xc, yc, 0.5 - 1.5j, -1.0 + 0.25j, **dots),
        "b5 card tensors": lambda: fused_axpby_dots(x, y, a4, b0, **dots),
        "b5 complex card tensors": lambda: fused_axpby_dots(
            xc, yc, ac4, bc0, **dots),
        "b1 gamma": lambda: sellcs_spmv(A64, V, opts=SpmvOpts(alpha=0.5,
                                                              gamma=6.0)),
        "b1 card alpha": lambda: sellcs_spmv(
            A64, V, V, opts=SpmvOpts(alpha=s0, beta=s1, gamma=gam,
                                     dot_xy=True)),
        "chebfd filter step": lambda: chebfd_mod._cheb_filter(
            op64, V, 2, 6.0, 6.0, 1.0, 2.0),
        "kpm moment step": lambda: kpm_mod.moment_step(op16, w, w, 1 / 3,
                                                       6.0, mu, mu),
        "tsmm card alpha": lambda: tsmm(V, X, V, s0, s1),
        "tsmttsm card beta": lambda: tsmttsm(V, V, X, s0, s1),
    }
    calls[case]()
    with _no_sync():
        calls[case]()


WIDE_DTYPES = [torch.float64, torch.float32, torch.bfloat16,
               torch.complex128, torch.complex64]
FLAGS = [(yy, xy, xx) for yy in (False, True) for xy in (False, True)
         for xx in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(
    n for n, on in zip(("yy", "xy", "xx"), f) if on) or "none")
@pytest.mark.parametrize("bw", [257, 512])
@pytest.mark.parametrize("dt", WIDE_DTYPES, ids=lambda d: str(d)[6:])
def test_b5_wide_blocks_on_card(dt, bw, flags):
    """B5 past one thread block's 256 slots against its plain version
    computed in float64 (complex128) from the same inputs, with
    per-column a and a scalar b: y' within 3 units (8 for complex values)
    of the accumulation dtype times |a||x| + |b||y| plus the output's
    rounding; each dot within (depth + 6) units of the accumulation dtype
    (plus 8 units of it for complex values, whose dots sum in complex128)
    times the sum of its terms' magnitudes, plus the plain version's own
    and, for complex64, the final rounding; one launch; a second call
    bit-equal."""
    need_card()
    n = 1031
    wide = torch.complex128 if dt.is_complex else torch.float64
    g = torch.Generator(device="cuda").manual_seed(bw)
    x, y = (torch.randn(n, bw, generator=g, dtype=wide,
                        device="cuda").to(dt) for _ in range(2))
    acc = dt if dt in (torch.float64, torch.complex128, torch.complex64) \
        else torch.float32
    a = torch.randn(bw, generator=g, dtype=wide, device="cuda").to(acc)
    b = -0.5 + 0.25j if dt.is_complex else -0.5
    fl = dict(dot_yy=flags[0], dot_xy=flags[1], dot_xx=flags[2])
    execution.reset_launch_counts()
    out, dots = fused_axpby_dots(x, y, a, b, **fl)
    torch.cuda.synchronize()
    assert execution.launch_counts().get("fused_axpby_dots", 0) == 1
    out2, dots2 = fused_axpby_dots(x, y, a, b, **fl)
    assert torch.equal(out, out2)
    assert (dots is None) == (not any(flags))
    if dots is not None:
        assert torch.equal(dots, dots2)
    xd, yd = x.to(wide), y.to(wide)
    want, wdots = fused_axpby_dots_ref(xd, yd, a.to(wide), b, **fl)
    u = torch.finfo(acc).eps / 2
    u_out = {torch.bfloat16: 2.0 ** -8}.get(dt, 0.0)
    mag = a.abs().double() * xd.abs() + abs(b) * yd.abs()
    k = 8 if dt.is_complex else 3
    lim = k * u * mag + u_out * want.abs() + 1e-300
    assert out.dtype == dt
    assert bool(((out.to(wide) - want).abs() <= lim).all())
    if dots is None:
        return
    depth = fused_update.summation_depth(n, bw, dt)
    scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                         (xd.abs() ** 2).sum(0)])
    if dt.is_complex:
        dlim = ((depth + 6) * 2.0 ** -53 + 8 * u) * scale + u * wdots.abs()
    else:
        dlim = (depth + 6) * u * scale + (n + 6) * 2.0 ** -53 * scale
    assert dots.dtype == acc
    assert bool(((dots.to(wide) - wdots).abs() <= dlim + 1e-300).all())
