"""The port's checkpoints (``repro_torch.train.checkpoint``): the
counterparts of ``tests/test_train.py``'s checkpoint cases, and
checkpoints crossing between the packages in both directions, bfloat16
leaves included, bit for bit.

A JAX bfloat16 array comes back from ``np.load`` as raw two-byte records
(``|V2``); the port writes its bfloat16 tensors as the same records, so
the JAX side views them as ``ml_dtypes.bfloat16`` (as it must view its
own).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.interop import (arrays_from_model, model_from_arrays,
                                 to_numpy)
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.trainer import TrainConfig, Trainer

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path, rng):
        tree = {"a": torch.from_numpy(rng.standard_normal((4, 5)).astype(
                    np.float32)),
                "b": {"c": torch.arange(7)},
                "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
        save_checkpoint(str(tmp_path), 3, tree)
        restored, man = restore_checkpoint(str(tmp_path), 3, tree)
        for key in ("a", "h"):
            assert restored[key].dtype == tree[key].dtype
            assert torch.equal(restored[key], tree[key])
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert man["step"] == 3
        assert man["keys"] == ["a", "b/c", "h"]

    def test_latest_and_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
        tree = {"x": torch.zeros(3)}
        for s in (1, 2, 3, 4):
            mgr.maybe_save(s, tree)
        assert latest_step(str(tmp_path)) == 4
        steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                       if n.startswith("step_"))
        assert steps == [3, 4]

    def test_every_and_force(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every=5, keep=3)
        tree = {"x": torch.zeros(1)}
        assert mgr.maybe_save(0, tree) is None
        assert mgr.maybe_save(3, tree) is None
        assert mgr.maybe_save(5, tree) is not None
        assert mgr.maybe_save(7, tree, force=True) is not None
        assert latest_step(str(tmp_path)) == 7

    def test_corrupt_tmp_ignored(self, tmp_path):
        os.makedirs(tmp_path / "step_9.tmp")
        os.makedirs(tmp_path / "step_8")          # no manifest: not valid
        save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
        assert latest_step(str(tmp_path)) == 1
        assert latest_step(str(tmp_path / "missing")) is None

    def test_shape_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
        with pytest.raises(ValueError):
            restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3)})

    def test_dtype_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
        with pytest.raises(ValueError):
            restore_checkpoint(str(tmp_path), 1,
                               {"x": torch.zeros(2, dtype=torch.bfloat16)})

    def test_resume_without_checkpoint(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "none"))
        assert mgr.resume({"x": torch.zeros(1)}) == (None, 0)


# ------------------------------------------------- across the two packages
ARCHS = ["qwen2_5_3b", "jamba_1_5_large_398b", "whisper_medium",
         "xlstm_1_3b"]


def _jax_flat(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _port_trainer(cfg, tmp_path, optimizer="adamw"):
    tc = TrainConfig(ckpt_dir=str(tmp_path), optimizer=optimizer)
    tr = Trainer(cfg, tc, seq_len=8, global_batch=2, device="cpu")
    tr.init_state()
    return tr


def _as_jax(a):
    """An array read from an ``.npz`` as the JAX package holds it."""
    return a.view(ml_dtypes.bfloat16) if a.dtype == np.dtype("V2") else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch, optimizer,
                                             dtype):
    """The JAX package saves ``(params, opt_state)`` after one update; the
    port's trainer restores it bit for bit, its keys and shapes are the
    port's own, and the restored model equals ``model_from_arrays`` of
    the JAX weights."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(get_smoke_config(arch),
                              dtype=getattr(torch, dtype))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    opt = JOPT.make_optimizer(optimizer)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 1e-2, p.dtype), params)
    params, state = opt.update(grads, state, params, 1e-3)
    JCK.save_checkpoint(str(tmp_path), 4, (params, state))

    tr = _port_trainer(cfg, tmp_path / "port", optimizer)
    restored, step = CheckpointManager(str(tmp_path)).resume(tr.state_tree())
    assert step == 4
    tr.load_state_tree(restored)
    flat = _jax_flat(str(tmp_path / "step_4"))
    save_checkpoint(str(tmp_path / "again"), 4, tr.state_tree())
    mine = _jax_flat(str(tmp_path / "again" / "step_4"))
    assert sorted(mine) == sorted(flat)
    for k, a in flat.items():
        assert mine[k].dtype == a.dtype and mine[k].shape == a.shape, k
        assert mine[k].tobytes() == a.tobytes(), k
    want = dict(model_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                  "cpu").named_parameters())
    for name, p in tr.model.named_parameters():
        assert p.dtype == want[name].dtype, name
        assert torch.equal(p, want[name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(tmp_path, arch, dtype):
    """The port's trainer saves its state after one step; the JAX
    package's ``restore_checkpoint`` reads it into the structure of its
    own ``(params, adamw state)``, every leaf bit for bit."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(get_smoke_config(arch),
                              dtype=getattr(torch, dtype))
    tc = TrainConfig(ckpt_dir=str(tmp_path), lr=1e-3, warmup=0)
    tr = Trainer(cfg, tc, seq_len=8, global_batch=2, device="cpu")
    tr.init_state()
    b = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                 generator=torch.Generator().manual_seed(0)),
         "labels": torch.randint(0, cfg.vocab_size, (2, 8),
                                 generator=torch.Generator().manual_seed(1))}
    if cfg.enc_dec:
        b["enc_embeds"] = torch.randn((2, 8, cfg.d_model))
    tr.train_step(b, 1)
    save_checkpoint(str(tmp_path), 1, tr.state_tree(), extra={"loss": 1.0})

    like = jax.eval_shape(lambda: (
        lambda p: (p, JOPT.adamw_init(p)))(
            JT.init_params(jcfg, jax.random.PRNGKey(0))))
    tree, man = JCK.restore_checkpoint(str(tmp_path), 1, like)
    assert man["step"] == 1 and man["extra"] == {"loss": 1.0}
    params, state = tree
    assert int(state["count"]) == 1
    ours = arrays_from_model(tr.model)
    for (path, got), (_, want) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, ours))):
        got = _as_jax(got)
        assert got.dtype == _as_jax(want).dtype, path
        assert got.tobytes() == want.tobytes(), path
    # the JAX weights build the same model in the port
    again = dict(model_from_arrays(
        cfg, jax.tree.map(lambda a: np.asarray(_as_jax(a)), params),
        "cpu").named_parameters())
    for name, p in tr.model.named_parameters():
        assert torch.equal(p, again[name]), name


@pytest.mark.parametrize("arch", ["whisper_medium", "jamba_1_5_large_398b"])
def test_arrays_from_model_is_the_trainer_tree(arch, tmp_path):
    """One owner of the stacked layout: a model's arrays are the
    trainer's parameter tree (the checkpoint's ``[0]``), key for key and
    byte for byte, bf16 leaves included."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.bfloat16)
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)), seq_len=8,
                 global_batch=2, device="cpu")
    tr.init_state()
    ours = arrays_from_model(tr.model)

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                same(a[k], b[k])
        else:
            want = to_numpy(b)
            assert a.dtype == want.dtype and a.tobytes() == want.tobytes()
    same(ours, tr.state_tree()[0])


def test_manifest_matches_the_jax_format(tmp_path):
    tree = ({"embed": {"table": torch.ones(3, 2)}},
            {"count": torch.zeros((), dtype=torch.int32),
             "m": {"embed": {"table": torch.zeros(3, 2)}}})
    save_checkpoint(str(tmp_path), 2, tree)
    man = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert man["keys"] == ["[0]/embed/table", "[1]/count",
                           "[1]/m/embed/table"]
    assert set(man) == {"step", "time", "keys", "extra"}
    jtree = ({"embed": {"table": jnp.ones((3, 2))}},
             {"count": jnp.zeros((), jnp.int32),
              "m": {"embed": {"table": jnp.zeros((3, 2))}}})
    JCK.save_checkpoint(str(tmp_path / "jax"), 2, jtree)
    jman = json.loads((tmp_path / "jax" / "step_2" / "manifest.json"
                       ).read_text())
    assert jman["keys"] == man["keys"]
