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

The ``gpu``-marked tests hold the CUDA kernel against its plain version
on the card; they skip here.
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
    assert fused_update.partition(0, 4) == (0, 0)
    assert fused_update.summation_depth(0, 4) == 0
    # tiles of 8 x 256 entries at bw = 4: 4,194,304 rows make 8192 tiles
    assert fused_update.partition(4_194_304, 4) == (8192, 528)
    # 16 tiles of 8 entries per thread, 64 lanes, 17 finishing loads, 5 steps
    assert fused_update.summation_depth(4_194_304, 4) == 128 + 64 + 17 + 5
    # bw = 3: a tile is 8 x 255 entries
    assert fused_update.partition(37, 3) == (1, 1)
    assert fused_update.summation_depth(37, 3) == 8 + 85 + 1 + 5
    # past bw = 85 a block has fewer threads than (dot, column) pairs;
    # at bw = 256 every thread is its column's only lane
    assert fused_update.partition(4109, 86) == (257, 257)
    assert fused_update.partition(37, 256) == (5, 5)
    assert fused_update.summation_depth(37, 256) == 8 + 1 + 1 + 5


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
    depth = fused_update.summation_depth(n, bw)
    scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                         (xd * xd).sum(0)])
    dlim = (depth + 6) * u * scale + (n + 6) * 2.0 ** -53 * scale
    assert dots.dtype == acc
    assert bool(((dots.double() - wdots).abs() <= dlim).all())
