"""Parity of the port's fused AXPBY + dots op (kernel B5,
``repro_torch.kernels.ops.fused_axpby_dots``) with the JAX package's.

The same numpy inputs go through the JAX op (its Pallas kernel in
interpret mode on the CPU; float64 under ``jax.enable_x64``) and the
port's op on CPU tensors (the kernel's plain version).  Tolerances, as
max |port - JAX| over the largest magnitude of the quantity: float64 1e-13
(the two sum the dots in other orders), float32 1e-5 (the dots; y' is
computed elementwise in the same order and agrees to 1e-6), and for
bfloat16/float16 outputs one unit of the output's last place (2^-7 and
2^-10 relative), because the two may round a float32 y' on opposite sides.

Complex operands: the port's plain path against the JAX op's (which
takes its plain path for complex), with the port's dots conjugated and
the JAX package's not (a deliberate difference).

The ``gpu``-marked tests hold the CUDA kernel, real and complex, against
its plain version on the card; they skip here.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.fused_update import fused_axpby_dots_pallas  # noqa: E402
from repro_torch.core import execution  # noqa: E402
from repro_torch.interop import tensor_from_array  # noqa: E402
from repro_torch.kernels import fused_update  # noqa: E402
from repro_torch.kernels.ops import fused_axpby_dots  # noqa: E402
from repro_torch.kernels.ref import fused_axpby_dots_ref  # noqa: E402

ml_dtypes = pytest.importorskip("ml_dtypes")

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": ml_dtypes.bfloat16, "float16": np.float16}
#: max |port - JAX| / max |JAX|, for y' and for the dots
TOL = {"float64": (1e-13, 1e-13), "float32": (1e-6, 1e-5),
       "bfloat16": (2.0 ** -7, 1e-5), "float16": (2.0 ** -10, 1e-5)}
FLAGS = [(yy, xy, xx) for yy in (False, True) for xy in (False, True)
         for xx in (False, True)]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _inputs(n, bw, dtype, seed=0, per_column=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, bw)).astype(DTYPES[dtype])
    y = rng.standard_normal((n, bw)).astype(DTYPES[dtype])
    if per_column:
        a = rng.standard_normal(bw)
        b = rng.standard_normal(bw)
    else:
        a, b = 0.75, -1.25
    return x, y, a, b


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    diff = np.abs(got - want).max() if want.size else 0.0
    return diff / scale if scale else diff


def _jax(x, y, a, b, flags, x64):
    with jax.enable_x64(x64):
        out, dots = jops.fused_axpby_dots(
            jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(a) if np.ndim(a) else a,
            jnp.asarray(b) if np.ndim(b) else b,
            dot_yy=flags[0], dot_xy=flags[1], dot_xx=flags[2])
        return (np.asarray(out, np.float64), out.dtype.name,
                None if dots is None else np.asarray(dots, np.float64))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(
    n for n, on in zip(("yy", "xy", "xx"), f) if on) or "none")
@pytest.mark.parametrize("per_column", [False, True],
                         ids=["scalar", "per_column"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_jax(dtype, per_column, flags):
    n, bw = 203, 3
    x, y, a, b = _inputs(n, bw, dtype, seed=len(dtype), per_column=per_column)
    jout, jdt, jdots = _jax(x, y, a, b, flags, dtype == "float64")
    out, dots = fused_axpby_dots(tensor_from_array(x, "cpu"),
                                 tensor_from_array(y, "cpu"),
                                 torch.as_tensor(a) if per_column else a,
                                 torch.as_tensor(b) if per_column else b,
                                 dot_yy=flags[0], dot_xy=flags[1],
                                 dot_xx=flags[2])
    assert str(out.dtype)[6:] == jdt == dtype
    vec_tol, dot_tol = TOL[dtype]
    assert _rel(out.double().numpy(), jout) <= vec_tol
    if not any(flags):
        assert dots is None and jdots is None
        return
    acc = torch.float64 if dtype == "float64" else torch.float32
    assert dots.dtype == acc and dots.shape == (3, bw)
    for k, on in enumerate(flags):
        if on:
            assert _rel(dots[k].numpy(), jdots[k]) <= dot_tol
        else:
            assert not dots[k].any() and not jdots[k].any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_one_dimensional_inputs_match_jax(dtype):
    x, y, a, b = _inputs(77, 1, dtype, seed=3)
    flags = (True, True, True)
    jout, _, jdots = _jax(x[:, 0], y[:, 0], a, b, flags, dtype == "float64")
    out, dots = fused_axpby_dots(torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(y[:, 0]), a, b,
                                 dot_yy=True, dot_xy=True, dot_xx=True)
    assert out.shape == (77,) and dots.shape == (3,)
    assert _rel(out.numpy(), jout) <= TOL[dtype][0]
    assert _rel(dots.numpy(), jdots) <= TOL[dtype][1]


@pytest.mark.parametrize("xd,yd", [("float32", "float64"),
                                   ("bfloat16", "float32"),
                                   ("float16", "bfloat16")])
def test_mixed_dtypes_follow_the_pallas_kernel(xd, yd):
    """The result has ``promote_types(x, y)``, as the Pallas kernel returns
    it; the JAX reference ``fused_axpby_dots_ref`` returns x's dtype
    instead (ROADMAP queue C)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 4)).astype(DTYPES[xd])
    y = rng.standard_normal((64, 4)).astype(DTYPES[yd])
    x64 = "float64" in (xd, yd)
    with jax.enable_x64(x64):
        jout, jdots = fused_axpby_dots_pallas(
            jnp.asarray(x), jnp.asarray(y), 0.5, 2.0, dot_yy=True,
            dot_xy=True, dot_xx=True, row_tile=64, interpret=True)
        jdt = jout.dtype.name
        jout = np.asarray(jout, np.float64)
        jdots = np.asarray(jdots, np.float64)
    out, dots = fused_axpby_dots(tensor_from_array(x, "cpu"),
                                 tensor_from_array(y, "cpu"), 0.5, 2.0,
                                 dot_yy=True, dot_xy=True, dot_xx=True)
    assert str(out.dtype)[6:] == jdt
    vec_tol, dot_tol = TOL[jdt]
    assert _rel(out.double().numpy(), jout) <= vec_tol
    assert _rel(dots.numpy(), jdots) <= dot_tol


def test_empty_rows_give_zero_dots():
    x = torch.zeros((0, 3), dtype=torch.float64)
    out, dots = fused_axpby_dots(x, x, 2.0, 3.0, dot_yy=True, dot_xx=True)
    assert out.shape == (0, 3)
    assert dots.shape == (3, 3) and not dots.any()


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="must match"):
        fused_axpby_dots(torch.zeros(5, 2), torch.zeros(5, 3))


def test_plain_version_on_the_cpu_launches_nothing():
    execution.reset_launch_counts()
    x = torch.ones(10, 2)
    fused_axpby_dots(x, x, dot_yy=True)
    assert execution.launch_counts().get("fused_axpby_dots", 0) == 0


def test_partition_and_depth():
    f64, f32, c128 = torch.float64, torch.float32, torch.complex128
    assert fused_update.summation_depth(0, 4, f64) == 0
    # float64 at bw = 4: vectors of 2 entries, periods of 4 (one row), 2
    # slots, 128 lanes, tiles of 4 x 128 periods: 4,194,304 rows make 8192
    # tiles over 264 blocks (132 SMs x 2) in 9 groups
    p = fused_update.partition(4_194_304, 4, f64)
    assert (p.vec, p.period, p.slots, p.slot_tiles, p.lanes, p.unroll,
            p.ntiles, p.nbx, p.ngroups) == (2, 4, 2, 1, 128, 4, 8192, 264, 9)
    # 32 tiles of 4 entries a thread, a butterfly over 16 lanes (4 steps)
    # and 8 warps, 32 blocks of a group, 9 groups of one offset
    assert fused_update.summation_depth(4_194_304, 4, f64) == (
        128 + 4 + 8 + 32 + 9)
    # float32: one slot of 4 columns a period, 256 lanes
    p = fused_update.partition(4_194_304, 4, f32)
    assert (p.vec, p.period, p.slots, p.lanes, p.ntiles) == (4, 4, 1, 256,
                                                             4096)
    # complex128: one value a vector, 4 slots
    assert fused_update.partition(4_096_000, 4, c128)[:3] == (1, 4, 4)
    # bw = 3 in float64: periods of 6 entries (two rows) in 3 slots, which
    # a warp does not divide: 85 lanes summed in order; one tile, one
    # block, one group of two offsets a column
    p = fused_update.partition(37, 3, f64)
    assert (p.period, p.slots, p.lanes, p.ntiles, p.nbx) == (6, 3, 85, 1, 1)
    assert fused_update.summation_depth(37, 3, f64) == 4 + 85 + 1 + 2
    # the half types: 8 entries a vector, 2 periods in flight
    p = fused_update.partition(1 << 20, 16, torch.bfloat16)
    assert (p.vec, p.period, p.slots, p.unroll, p.nbx) == (8, 16, 2, 2, 264)
    # past 256 slots: slot tiles along grid.y, one lane each, and half
    # the blocks along x; bw = 257 takes periods of two rows
    p = fused_update.partition(4109, 257, f64)
    assert (p.period, p.slots, p.slot_tiles, p.slot_tile, p.lanes,
            p.nbx) == (514, 257, 2, 129, 1, 132)
    p = fused_update.partition(4109, 512, c128)
    assert (p.slots, p.slot_tiles, p.slot_tile, p.lanes) == (512, 2, 256, 1)
    # an empty block with dots still takes one block (it writes zeros)
    assert fused_update.partition(0, 4, f64).nbx == 1


COEF_KINDS = ["number", "0-d tensor", "per-column tensor"]


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("kind", COEF_KINDS)
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_coefficients_broadcast_as_the_jax_kernel(dtype, kind, complex_):
    """The coefficient helpers give the (bw,) values the JAX kernel
    broadcasts (``jnp.broadcast_to(jnp.asarray(a, acc), (bw,))``) for a
    number, a 0-d tensor and a (bw,) tensor, in the accumulation dtype
    (complex128 / complex64 for complex values): a number and a 0-d host
    tensor go to the kernel by value, a (bw,) tensor as its values."""
    from repro_torch.kernels.sellcs_spmv import coefficient_arg
    bw = 5
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(bw) + (1j * rng.standard_normal(bw)
                                      if complex_ else 0.0)
    if complex_:
        acc = {"float64": torch.complex128}.get(dtype, torch.complex64)
        jacc = {"float64": jnp.complex128}.get(dtype, jnp.complex64)
    else:
        acc = torch.float64 if dtype == "float64" else torch.float32
        jacc = jnp.float64 if dtype == "float64" else jnp.float32
    c = {"number": complex(vals[0]) if complex_ else float(vals[0]),
         "0-d tensor": torch.tensor(vals[0]),
         "per-column tensor": torch.from_numpy(vals)}[kind]
    with jax.enable_x64(True):
        jc = np.asarray(c) if isinstance(c, torch.Tensor) else c
        want = np.asarray(jnp.broadcast_to(jnp.asarray(jc, jacc), (bw,)))
    got = fused_update.coefficients(c, bw, acc, "cpu")
    assert got.dtype == acc and got.shape == (bw,)
    np.testing.assert_array_equal(got.numpy(), want)
    arg = coefficient_arg("f", "a", c, acc, "cpu", bw)
    assert (arg.values is None) == (kind != "per-column tensor")


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, False)],
                         ids=["all", "xy"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wide_block_plain_path_matches_jax(dtype, flags):
    """B5's plain path at bw = 300, past one thread block's 256 slots on
    the card (its slot tiles), against the JAX op with per-column a and a
    scalar b: the tolerances of :func:`test_matches_jax`."""
    x, y, a, _ = _inputs(67, 300, dtype, seed=11, per_column=True)
    b = -0.375
    jout, jdt, jdots = _jax(x, y, a, b, flags, dtype == "float64")
    out, dots = fused_axpby_dots(tensor_from_array(x, "cpu"),
                                 tensor_from_array(y, "cpu"),
                                 torch.from_numpy(a), b, dot_yy=flags[0],
                                 dot_xy=flags[1], dot_xx=flags[2])
    assert str(out.dtype)[6:] == jdt == dtype and dots.shape == (3, 300)
    vec_tol, dot_tol = TOL[dtype]
    assert _rel(out.double().numpy(), jout) <= vec_tol
    for k, on in enumerate(flags):
        if on:
            assert _rel(dots[k].numpy(), jdots[k]) <= dot_tol
        else:
            assert not dots[k].any() and not jdots[k].any()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_update.fused_axpby_dots_cuda(x, x)


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True),
                                   (True, False, True)],
                         ids=["none", "all", "yy_xx"])
@pytest.mark.parametrize("n,bw", [(0, 3), (1, 1), (37, 4), (4109, 3),
                                  (1 << 18, 16), (4109, 86), (37, 256),
                                  (1 << 16, 256)])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32, torch.bfloat16,
                                torch.float16])
def test_kernel_matches_plain_on_card(dt, n, bw, flags):
    """The kernel against its plain version computed in float64 from the
    same inputs: y' within 3 units of the accumulation dtype times
    |a x| + |b y| plus half a unit of the output; each dot within
    (depth + 6) units times the sum of its terms' magnitudes."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(n + bw)
    x, y = (torch.randn(n, bw, generator=g, dtype=torch.float64,
                        device="cuda").to(dt) for _ in range(2))
    acc = torch.float64 if dt == torch.float64 else torch.float32
    a = torch.randn(bw, generator=g, dtype=torch.float64,
                    device="cuda").to(acc)
    b = -0.5
    execution.reset_launch_counts()
    out, dots = fused_axpby_dots(x, y, a, b, dot_yy=flags[0],
                                 dot_xy=flags[1], dot_xx=flags[2])
    torch.cuda.synchronize()
    launched = execution.launch_counts().get("fused_axpby_dots", 0)
    assert launched == (1 if (n or any(flags)) else 0)
    xd, yd = x.double(), y.double()
    want, wdots = fused_axpby_dots_ref(xd, yd, a.double(), b,
                                       dot_yy=flags[0], dot_xy=flags[1],
                                       dot_xx=flags[2])
    u = 2.0 ** -53 if acc == torch.float64 else 2.0 ** -24
    u_out = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}.get(dt, 0.0)
    mag = a.double().abs() * xd.abs() + abs(b) * yd.abs()
    assert out.dtype == dt
    fi = torch.finfo(dt)
    lim = 3 * u * mag + u_out * want.abs() + fi.tiny * fi.eps
    assert bool(((out.double() - want).abs() <= lim).all())
    if not any(flags):
        assert dots is None
        return
    depth = fused_update.summation_depth(n, bw, dt)
    scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                         (xd * xd).sum(0)])
    dlim = (depth + 6) * u * scale + (n + 6) * 2.0 ** -53 * scale
    assert dots.dtype == acc
    assert bool(((dots.double() - wdots).abs() <= dlim).all())


CDTYPES = {"complex128": np.complex128, "complex64": np.complex64}


def _cinputs(n, bw, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x, y = ((rng.standard_normal((n, bw)) + 1j * rng.standard_normal((n, bw)))
            .astype(dtype) for _ in range(2))
    a = (rng.standard_normal(bw) + 1j * rng.standard_normal(bw)).astype(dtype)
    return x, y, a, 0.5 - 1.25j


@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_complex_plain_path_matches_jax(dname):
    """Complex x and y through the port's plain path and the JAX op (which
    takes its plain path for complex): y' within 1e-13 (complex128) or
    1e-6 (complex64) of max |y'|.  The port's dots are conjugate-linear in
    the first argument, summed in complex128; they are held to the
    conjugated sums of the JAX y', within 1e-13 / 1e-6 of the largest,
    and the JAX dots to its own unconjugated sums (a deliberate
    difference)."""
    dtype = CDTYPES[dname]
    tol = 1e-13 if dtype == np.complex128 else 1e-6
    x, y, a, b = _cinputs(301, 5, dtype, seed=4)
    out, dots = fused_axpby_dots(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(a), b, dot_yy=True,
                                 dot_xy=True, dot_xx=True)
    with jax.enable_x64(dtype == np.complex128):
        jo, jd = jops.fused_axpby_dots(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(a), b, dot_yy=True,
                                       dot_xy=True, dot_xx=True)
        jo, jd = np.asarray(jo), np.asarray(jd)
    assert out.dtype == torch.from_numpy(x).dtype == dots.dtype
    assert str(jo.dtype) == dname
    yn = jo.astype(np.complex128)
    xc = x.astype(np.complex128)
    for got, want in ((out.numpy(), yn),
                      (dots.numpy(), [np.sum(yn.conj() * yn, 0),
                                      np.sum(xc.conj() * yn, 0),
                                      np.sum(xc.conj() * xc, 0)]),
                      (jd, [np.sum(yn * yn, 0), np.sum(xc * yn, 0),
                            np.sum(xc * xc, 0)])):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    norms = dots.numpy()[[0, 2]]
    assert np.abs(norms.imag).max() <= tol * np.abs(norms.real).max()


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True),
                                   (False, True, False)],
                         ids=["none", "all", "xy"])
@pytest.mark.parametrize("n,bw", [(0, 3), (1, 1), (37, 4), (4109, 3),
                                  (1 << 18, 16), (4109, 86), (37, 256)])
@pytest.mark.parametrize("dt", [torch.complex128, torch.complex64])
def test_complex_kernel_matches_plain_on_card(dt, n, bw, flags):
    """B5's complex variant against its plain version computed in
    complex128 from the same inputs, with complex a (per column) and b:
    y' within 8 units of the accumulation dtype times |a||x| + |b||y|;
    each dot within (depth + 6) units of complex128 plus 8 units of the
    accumulation dtype, times the sum of its terms' magnitudes, plus one
    unit of the dots' dtype (the final rounding of a complex64 dot)."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(n + bw)
    x, y = (torch.randn(n, bw, generator=g, dtype=torch.complex128,
                        device="cuda").to(dt) for _ in range(2))
    a = torch.randn(bw, generator=g, dtype=torch.complex128,
                    device="cuda").to(dt)
    b = -0.5 + 0.25j
    execution.reset_launch_counts()
    out, dots = fused_axpby_dots(x, y, a, b, dot_yy=flags[0],
                                 dot_xy=flags[1], dot_xx=flags[2])
    torch.cuda.synchronize()
    launched = execution.launch_counts().get("fused_axpby_dots", 0)
    assert launched == (1 if (n or any(flags)) else 0)
    xd, yd = x.to(torch.complex128), y.to(torch.complex128)
    want, wdots = fused_axpby_dots_ref(xd, yd, a.to(torch.complex128), b,
                                       dot_yy=flags[0], dot_xy=flags[1],
                                       dot_xx=flags[2])
    u = 2.0 ** -53 if dt == torch.complex128 else 2.0 ** -24
    mag = a.abs().double() * xd.abs() + abs(b) * yd.abs()
    assert out.dtype == dt
    assert bool(((out.to(torch.complex128) - want).abs()
                 <= 8 * u * mag + 1e-300).all())
    if not any(flags):
        assert dots is None
        return
    depth = fused_update.summation_depth(n, bw, dt)
    scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                         (xd.abs() ** 2).sum(0)])
    dlim = ((depth + 6) * 2.0 ** -53 + 8 * u) * scale + u * wdots.abs()
    assert dots.dtype == dt
    assert bool(((dots.to(torch.complex128) - wdots).abs() <= dlim).all())
    # a real operand of the same precision is widened, as the plain
    # version promotes it
    xr = x.real.contiguous()
    out2, _ = fused_axpby_dots(xr, y, a, b)
    want2, _ = fused_axpby_dots_ref(xr.double(), yd, a.to(torch.complex128),
                                    b)
    assert out2.dtype == dt
    assert bool(((out2.to(torch.complex128) - want2).abs()
                 <= 8 * u * mag + 1e-300).all())
