"""xLSTM's float32 decode against its forward at published width, in both
packages.

xlstm-1.3b at its FULL widths (d 2048, 4 heads, vocab 50,304) in
float32, B 1, S 64, the JAX package's weights carried across: the logits
of 64 ``decode_step`` calls against those of one ``forward``, in the JAX
package and in the port, and the port against the JAX package.  The
recurrences' exponential gates amplify float32 round-off, and they do so
in the JAX package as much as in the port: over one whole period (7 mLSTM
and 1 sLSTM layers) on the CPU the JAX package's decode drifts 1.53e-3 of
max |logit| and the port's 6.4e-4 (the port's forward is 6.3e-4 from the
JAX one); an NVIDIA H100 gave the port 1.01e-3.  So the drift is a property of
the recurrence, not a fault of the port.

The test takes one mLSTM and one sLSTM layer (a whole period needs about
6 GB and 80 s here) and pins what it measures: the JAX package 1.46e-5,
the port 1.20e-5, the port's forward 4.2e-6 from the JAX one.  The
bounds leave a factor of four for other BLAS builds, and the port may
not drift more than the JAX package.  Run this file as a script for a
whole period::

    PYTHONPATH=src python tests/test_torch_xlstm_drift.py --layers 8
"""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import model_from_arrays  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SEQ = 64


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _configs(layers: int):
    jfull, full = jax_get_config("xlstm_1_3b"), get_config("xlstm_1_3b")
    if layers == 2:                    # one mLSTM and one sLSTM layer
        pat = (("mlstm", "none"), ("slstm", "none"))
        return (dataclasses.replace(jfull, pattern=pat, n_layers=2,
                                    dtype=jnp.float32),
                dataclasses.replace(full, pattern=pat, n_layers=2,
                                    dtype=torch.float32))
    return (dataclasses.replace(jfull, n_layers=layers, dtype=jnp.float32),
            dataclasses.replace(full, n_layers=layers, dtype=torch.float32))


def drift(layers: int = 2):
    """``{"jax", "port", "forward"}``: each package's decode against its
    forward, and the port's forward against the JAX one, as max |diff| /
    max |logit|."""
    jcfg, cfg = _configs(layers)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, SEQ)).astype(np.int32)
    jfwd, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tok)},
                         remat=False)
    step = jax.jit(lambda p, c, t, n: JT.decode_step(jcfg, p, c, t, n))
    cache, outs = JT.init_cache(jcfg, 1, SEQ), []
    for t in range(SEQ):
        logits, cache = step(params, cache, jnp.asarray(tok[:, t:t + 1]), t)
        outs.append(np.asarray(logits)[:, 0])
    jdec, jfwd = np.stack(outs, 1), np.asarray(jfwd)
    model = model_from_arrays(cfg, jax.tree.map(np.asarray, params), "cpu")
    del params, cache
    with torch.no_grad():
        tt = torch.from_numpy(tok)
        fwd, _ = T.forward(cfg, model, {"tokens": tt})
        cache, outs = T.init_cache(cfg, 1, SEQ, "cpu"), []
        for t in range(SEQ):
            logits, cache = T.decode_step(cfg, model, cache, tt[:, t:t + 1],
                                          t)
            outs.append(logits[:, 0])
    dec, fwd = torch.stack(outs, 1).numpy(), fwd.numpy()
    return {"jax": _rel(jdec, jfwd), "port": _rel(dec, fwd),
            "forward": _rel(fwd, jfwd)}


def test_decode_drift_is_the_recurrences_in_both_packages():
    d = drift(2)
    assert 1.46e-5 / 4 <= d["jax"] <= 1.46e-5 * 4, d
    assert 1.20e-5 / 4 <= d["port"] <= 1.20e-5 * 4, d
    assert d["forward"] <= 4.2e-6 * 4, d
    assert d["port"] <= d["jax"] * 1.5, d


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2,
                    help="2 (one mLSTM, one sLSTM) or a multiple of 8")
    print(drift(ap.parse_args().layers))
