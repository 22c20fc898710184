"""``train.optimizer.compressed_psum`` on 4 ``gloo`` ranks against the JAX
package's on 4 forced host devices (``shard_map`` over a ``"pod"`` axis,
as ``tests/test_train.py::test_compressed_psum_multidevice`` runs it),
on the same numpy inputs: the JAX test's ``arange(32).reshape(4, 8) /
7`` and seeded random float32 and bfloat16 inputs, one row a rank.

* int8: bit for bit equal to the JAX package's, and to the int32 sum of
  the inputs quantised with the group's largest scale (numpy, rounding
  half to even); within ``world * scale / 2`` of the float64 sum.
* bf16: within 2^-6 of the sum of |x| over the ranks, elementwise, of
  the JAX package's and of the float64 sum (each package rounds the
  inputs and three partial sums to bfloat16, each rounding off by at
  most 2^-9 of that sum).
* Every rank gets the same result, the input is not changed, and a
  sub-group reduces over its own ranks only.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_ranks as R
from conftest import SRC

WORLD = 4


def _inputs():
    rng = np.random.default_rng(23)
    scales = np.array([1.0, 1e-3, 40.0, 0.5], np.float32)
    return {
        "jax_test": (np.arange(4 * 8, dtype=np.float32).reshape(4, 8) / 7.0,
                     "float32"),
        "normal": (rng.standard_normal((WORLD, 1000)).astype(np.float32),
                   "float32"),
        "ranks_scaled": ((rng.standard_normal((WORLD, 64, 33))
                          * scales[:, None, None]).astype(np.float32),
                         "float32"),
        "ties": (np.tile(np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                                  np.float32), (WORLD, 1)), "float32"),
        "bf16": (rng.standard_normal((WORLD, 500)).astype(np.float32),
                 "bfloat16"),
    }


REF_CODE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.optimizer import compressed_psum
from repro.core.distributed import shard_map
src, dst = sys.argv[1], sys.argv[2]
mesh = Mesh(np.array(jax.devices()).reshape(4), ("pod",))
out = {}
with np.load(src) as z:
    for name in z.files:
        x = jnp.asarray(z[name])
        if name.startswith("bf16"):
            x = x.astype(jnp.bfloat16)
        for bits in (8, 16):
            spec = P("pod", *([None] * (x.ndim - 1)))
            f = lambda xs, bits=bits: compressed_psum(xs[0], "pod",
                                                      bits=bits)[None]
            y = shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec)(x)
            out[f"{name}/{bits}"] = np.asarray(y).astype(np.float64)
np.savez(dst, **out)
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX package's results (a subprocess, started first) and the
    port's four ranks', once."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("psum")
    inputs = _inputs()
    np.savez(root / "in.npz", **{k: v for k, (v, _) in inputs.items()})
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", REF_CODE,
                             str(root / "in.npz"), str(root / "ref.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    port = R.run_ranks(R.psum_ranks, root / "ranks", WORLD, inputs)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "SUBPROCESS_OK" in out, err[-3000:]
    return dict(inputs=inputs, port=port, ref=dict(np.load(root / "ref.npz")))


NAMES = list(_inputs())


def _quantised_sum(x: np.ndarray) -> np.ndarray:
    """The int8 path in numpy, float32 throughout: the group's scale, the
    int32 sum of the rounded quotients, times the scale."""
    scale = max(np.float32(np.abs(r).max()) / np.float32(127.0)
                + np.float32(1e-12) for r in x)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    return q.sum(0).astype(np.float32) * scale, scale


def _as_input(run, name):
    arr, dtype = run["inputs"][name]
    if dtype == "bfloat16":        # round to bfloat16, as both packages do
        import torch
        arr = torch.from_numpy(arr).bfloat16().float().numpy()
    return arr, dtype


@pytest.mark.parametrize("name", NAMES)
def test_int8_bit_identical_to_jax(run, name):
    want = run["ref"][f"{name}/8"][0]
    for rank in run["port"]:
        got = rank[name][8]
        assert got.tobytes() == want.tobytes(), np.abs(got - want).max()


@pytest.mark.parametrize("name", NAMES)
def test_int8_is_the_quantised_sum(run, name):
    x, dtype = _as_input(run, name)
    want, scale = _quantised_sum(x)
    if dtype == "bfloat16":
        import torch
        want = torch.from_numpy(want).bfloat16().double().numpy()
    got = run["port"][0][name][8]
    np.testing.assert_array_equal(got, want.astype(np.float64))
    exact = x.astype(np.float64).sum(0)
    bound = WORLD * float(scale) / 2 + (np.abs(exact) * 2.0 ** -8
                                        if dtype == "bfloat16" else 0.0)
    assert (np.abs(got - exact) <= bound * (1 + 1e-6)).all()


@pytest.mark.parametrize("name", NAMES)
def test_bf16_within_its_tolerance(run, name):
    x, _ = _as_input(run, name)
    tol = 2.0 ** -6 * np.abs(x.astype(np.float64)).sum(0)
    want = run["ref"][f"{name}/16"][0]
    exact = x.astype(np.float64).sum(0)
    for rank in run["port"]:
        got = rank[name][16]
        assert (np.abs(got - want) <= tol).all()
        assert (np.abs(got - exact) <= tol).all()


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_same_and_input_unchanged(run, name):
    for rank in run["port"]:
        assert rank[name]["unchanged"]
        for bits in (8, 16):
            assert rank[name][bits].tobytes() == \
                run["port"][0][name][bits].tobytes()


def test_sub_group_reduces_its_own_ranks(run):
    """Ranks 0 and 1 sum 1 and 2 over their own group: 3 (exact in int8:
    the scale is 2 / 127, so 1 and 2 quantise to 63.5 -> 64 and 127)."""
    for rank in run["port"][:2]:
        want = np.float32(2.0 / 127.0 + 1e-12) * np.float32(64 + 127)
        np.testing.assert_array_equal(rank["pair"],
                                      np.full(3, want, np.float64))
    assert all("pair" not in rank for rank in run["port"][2:])
