"""Kernel B6 (``csrc/mamba_scan.cu``, the selective scan) against its plain
version on the card, and the wrapper's contract.

The ``gpu``-marked tests need an NVIDIA GPU and ``nvcc``; each decides
inside itself whether a card exists and skips here.  The kernel is held to
``kernels.mamba_scan.error_bound``, a first-order bound on its float32
rounding against the plain version computed in float64 from the same
inputs (twice the first-order terms), so the tolerance grows with the
length of the recurrence and shrinks where the state decays.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import execution
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels.ops import mamba_scan
from repro_torch.kernels.ref import mamba_scan_ref


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def inputs(B, S, di, N, seed=0, device="cpu", dt_scale=0.1, dt_max=None):
    """dt >= 0 from 0 to large (a tenth of the entries 0, a tenth large
    enough that exp(dt A) underflows: 200, or log-uniform in [1, dt_max]),
    A <= 0 (a column of zeros)."""
    rng = np.random.default_rng(seed)
    dt = np.abs(rng.standard_normal((B, S, di))) * dt_scale
    dt[rng.random((B, S, di)) < 0.1] = 0.0
    big = (200.0 if dt_max is None
           else np.exp(rng.random((B, S, di)) * np.log(dt_max)))
    dt = np.where(rng.random((B, S, di)) < 0.1, big, dt)
    xc = rng.standard_normal((B, S, di))
    Bc = rng.standard_normal((B, S, N))
    Cc = rng.standard_normal((B, S, N))
    A = -np.exp(rng.standard_normal((di, N)))
    A[:, 0] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (dt, xc, Bc, Cc, A))


def test_cpu_tensors_run_the_plain_version():
    args = inputs(2, 9, 5, 3)
    execution.reset_launch_counts()
    torch.testing.assert_close(mamba_scan(*args), mamba_scan_ref(*args),
                               rtol=0, atol=0)
    torch.testing.assert_close(mamba_scan(*args, impl="ref"),
                               mamba_scan_ref(*args), rtol=0, atol=0)
    assert execution.launch_counts().get("mamba_scan", 0) == 0


def test_wrapper_checks_shapes_and_impl():
    dt, xc, Bc, Cc, A = inputs(1, 4, 3, 2)
    with pytest.raises(ValueError, match="impl"):
        mamba_scan(dt, xc, Bc, Cc, A, impl="pallas")
    with pytest.raises(ValueError, match="must both be"):
        mamba_scan(dt, xc[:, :3], Bc, Cc, A)
    with pytest.raises(ValueError, match="A"):
        mamba_scan(dt, xc, Bc, Cc, A[:2])
    with pytest.raises(ValueError, match="Cc"):
        mamba_scan(dt, xc, Bc, Cc[..., :1], A)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ms.mamba_scan_cuda(dt, xc, Bc, Cc, A)


@pytest.mark.parametrize("chunk", [1, 7, 1 << 22])
def test_plain_loops_do_not_depend_on_how_many_steps_they_form_at_once(
        monkeypatch, chunk):
    """The plain scan and ``error_bound`` form ``exp(dt A)`` and the
    inputs for up to ``SCAN_CHUNK`` values of steps at once; the values
    are those of a loop that forms them one step at a time."""
    import repro_torch.kernels.ref as ref
    args = inputs(2, 11, 5, 3, seed=4, dt_max=300.0)
    wide = tuple(a.double() for a in args)
    monkeypatch.setattr(ref, "SCAN_CHUNK", 1)          # one step at a time
    want_y, want_bound = mamba_scan_ref(*wide), ms.error_bound(*args)
    monkeypatch.setattr(ref, "SCAN_CHUNK", chunk)
    torch.testing.assert_close(mamba_scan_ref(*wide), want_y, rtol=0, atol=0)
    torch.testing.assert_close(ms.error_bound(*args), want_bound, rtol=0,
                               atol=0)
    assert ref.scan_chunks(11, 15) == [(s, min(11, s + max(1, chunk // 15)))
                                       for s in range(0, 11,
                                                      max(1, chunk // 15))]


def test_error_bound_holds_for_the_plain_float32_version():
    """The plain version in float32 rounds at the places the kernel does
    (though ``torch.exp`` is not CUDA's expf), so the bound must hold for
    it too; and it is not vacuous: the error uses a fair part of it."""
    args = inputs(2, 300, 6, 4, seed=3)
    got = mamba_scan_ref(*args).double()
    want = mamba_scan_ref(*(a.double() for a in args))
    bound = ms.error_bound(*args)
    ratio = ((got - want).abs() / bound).max().item()
    assert 1e-3 < ratio <= 1.0, ratio


#: the shapes of the card tests
CARD_SHAPES = [
    (1, 1, 1, 1), (1, 7, 8, 4), (3, 64, 100, 16), (2, 257, 130, 16),
    (1, 300, 64, 33), (2, 70, 40, 64), (1, 16, 8, 2), (2, 64, 32, 4),
    (1, 128, 64, 8), (3, 32, 16, 16)]
#: (B, S, di, N, dt_max): the card tests' shapes, the plain-version test's,
#: and a long run with dt log-uniform up to 300 (deep underflow)
CPU_CASES = ([(*shape, None) for shape in CARD_SHAPES]
             + [(2, 300, 6, 4, None), (1, 257, 16, 16, 300.0)])


def _cpu_inputs(B, S, di, N, dt_max):
    return inputs(B, S, di, N, seed=B * S + di + N, dt_max=dt_max)


def scan_at_stated_worst(dt, xc, Bc, Cc, A, sign):
    """The plain scan in float32 with each exponential as the kernel takes
    it, at the worst ``error_bound`` allows: ``2^fl(dt fl(A fl(log2 e)))``
    moved by the stated relative error ``EXP_REL`` away from the exact
    value (up for ``sign = 1``, down for ``-1``), kept within it when
    rounded to float32, and flushed to 0 below ``2^-126`` (``.ftz``)."""
    rel = ms.EXP_REL
    a2 = A * torch.tensor(np.log2(np.e), dtype=torch.float32)
    B, S, di = dt.shape
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32)
    y = torch.empty((B, S, di), dtype=torch.float32)
    toward_exact = torch.tensor(-sign * float("inf"))
    for s in range(S):
        exact = torch.exp2((dt[:, s, :, None] * a2).double())
        e = (exact * (1.0 + sign * rel)).float()
        over = (e.double() - exact).abs() > rel * exact
        e = torch.where(over, torch.nextafter(e, toward_exact.float()), e)
        e = torch.where(e < ms.EXP_FLUSH, 0.0, e)
        h = e * h + (dt[:, s] * xc[:, s])[..., None] * Bc[:, s, None, :]
        y[:, s] = (h * Cc[:, s, None, :]).sum(-1)
    return y


def expf_bound(dt, xc, Bc, Cc, A):
    """The bound of the earlier kernel, whose ``expf`` (2 ulp) took the
    rounded ``fl(dt A)``: the yardstick ``error_bound`` may not fall
    below."""
    u, tiny = 2.0 ** -24, 2.0 ** -148
    dt, xc, Bc, Cc, A = (t.double() for t in (dt, xc, Bc, Cc, A))
    B, S, di = dt.shape
    N = A.shape[1]
    H = torch.zeros((B, di, N), dtype=torch.float64)
    E = torch.zeros_like(H)
    out = torch.empty((B, S, di), dtype=torch.float64)
    for s in range(S):
        z = dt[:, s, :, None] * A
        a = torch.exp(z)
        b = ((dt[:, s] * xc[:, s])[..., None] * Bc[:, s, None, :]).abs()
        E = (a * E + ((6.0 + z.abs()) * u * a + tiny) * H + 3.0 * u * b
             + tiny)
        H = a * H + b
        c = Cc[:, s].abs()[:, None, :]
        out[:, s] = 2.0 * ((c * E).sum(-1) + N * u * (c * H).sum(-1))
    return out


@pytest.mark.parametrize("sign", [1, -1], ids=["up", "down"])
@pytest.mark.parametrize("B,S,di,N,dt_max", CPU_CASES)
def test_error_bound_holds_for_the_exponential_at_its_stated_worst(
        B, S, di, N, dt_max, sign):
    """The kernel's arithmetic, emulated with every exponential off by the
    most its stated error allows, stays within ``error_bound``."""
    args = _cpu_inputs(B, S, di, N, dt_max)
    got = scan_at_stated_worst(*args, sign).double()
    want = mamba_scan_ref(*(a.double() for a in args))
    assert torch.all((got - want).abs() <= ms.error_bound(*args))


@pytest.mark.parametrize("B,S,di,N,dt_max", CPU_CASES)
def test_error_bound_is_never_below_the_expf_bound(B, S, di, N, dt_max):
    args = _cpu_inputs(B, S, di, N, dt_max)
    assert torch.all(ms.error_bound(*args) >= expf_bound(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,N", CARD_SHAPES)
def test_kernel_matches_plain_on_card(B, S, di, N):
    need_card()
    args = inputs(B, S, di, N, seed=B * S + di + N, device="cuda")
    execution.reset_launch_counts()
    got = mamba_scan(*args)
    torch.cuda.synchronize()
    assert execution.launch_counts()["mamba_scan"] == 1
    assert got.dtype == torch.float32 and got.shape == (B, S, di)
    want = mamba_scan_ref(*(a.double() for a in args))
    bound = ms.error_bound(*args)
    assert torch.all((got.double() - want).abs() <= bound)


@pytest.mark.gpu
def test_empty_shapes_launch_nothing_wrong():
    need_card()
    for shape in ((0, 4, 8, 2), (2, 0, 8, 2), (2, 4, 0, 2)):
        args = inputs(*shape, device="cuda")
        assert mamba_scan(*args).shape == shape[:3]
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    need_card()
    dt, xc, Bc, Cc, A = inputs(1, 8, 16, 4, device="cuda")
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32"):
            mamba_scan(dt.to(dtype), xc, Bc, Cc, A)
        with pytest.raises(TypeError, match="float32"):
            mamba_scan(dt, xc, Bc, Cc, A.to(dtype))
    wide = torch.zeros((1, 8, 32), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba_scan_cuda(dt, wide[..., ::2], Bc, Cc, A)
    # the op hands the kernel contiguous copies of strided operands
    torch.testing.assert_close(mamba_scan(dt, wide[..., ::2], Bc, Cc, A),
                               mamba_scan(dt, torch.zeros_like(dt), Bc, Cc,
                                          A), rtol=0, atol=0)
    # a state size past the old limit of 64 launches, within the bound
    big = inputs(1, 8, 16, 65, device="cuda")
    got = mamba_scan(*big)
    want = mamba_scan_ref(*(a.double() for a in big))
    assert bool(((got - want).abs() <= ms.error_bound(*big)).all())
