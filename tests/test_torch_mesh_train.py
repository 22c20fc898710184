"""The port's trainer on a ``("data", "model")`` mesh of ranks against the
JAX package's trainer on a mesh of 4 forced host devices, on the CPU.

Four ``gloo`` ranks (``tests/torch_ranks.py``) train the float32 SMOKE
configs of qwen2.5-3b and grok-1 (routers x 20, as in
``tests/test_torch_train.py``; capacity factor 8, which drops no token,
and for grok-1 also the config's own 1.25, which drops some) from the
JAX package's initial weights,
which both packages load; the JAX ``Trainer`` runs the same steps on
``Mesh((2, 2))`` in a subprocess started beside the ranks.  Global batch
4, sequence 16, lr 1e-3 warmed up over 2 steps.

* Four steps on (2, 2), under every layout (``tp``, ``fsdp``,
  ``zero1``), AdamW and Adafactor, ``grad_accum`` 1 and 2, and grok-1
  at the capacity factor 1.25 also on (4, 1): each loss
  within 1e-5 of the JAX trainer's and of the port's one-device
  trainer's; every parameter leaf within 1e-4 of its largest JAX entry
  afterwards, except the attention key biases (``attn/bk``: softmax is
  invariant to them, so their exact gradient is 0 and Adam normalises
  round-off into steps; held to 1e-6 absolute); on every rank the same
  loss, and after each step the same checksum of the full parameters;
  each rank holds exactly ``shard_bytes`` of optimizer slots.
* Resuming on the same mesh: the losses equal an uninterrupted run's,
  bit for bit; a state restored onto (4, 1) equals the checkpoint bit
  for bit.
* Elastic restore: a JAX checkpoint from (2, 2) resumed by the port on
  (4, 1), and a port checkpoint from (2, 2) resumed by the JAX package
  on (4, 1): the next two losses within 1e-5 (relative) of the other
  package's own continuation; the port's checkpoint resumed on one device likewise.
* ``launch.train`` under ``torchrun``'s environment trains on (2, 2).
"""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ranks as R
from conftest import SRC
from repro_torch.interop import nest

ARCHS = ("qwen2_5_3b", "grok_1_314b")
LAYOUTS = ("tp", "fsdp", "zero1")
#: (optimizer, grad_accum, capacity factor): 8 drops no token, None is
#: the SMOKE config's own (1.25), at which the dispatch drops tokens
RUNS = {"qwen2_5_3b": (("adamw", 1, 8.0), ("adamw", 2, 8.0),
                       ("adafactor", 1, 8.0), ("adafactor", 2, 8.0)),
        "grok_1_314b": (("adamw", 2, 8.0), ("adafactor", 1, 8.0),
                        ("adafactor", 1, None))}
DROPS = ("grok_1_314b", "adafactor", 1, None)
CASES = [(a, lay, (2, 2), o, g, cf) for a in ARCHS for lay in LAYOUTS
         for o, g, cf in RUNS[a]] + [
    ("grok_1_314b", "tp", (4, 1), "adafactor", 1, None)]
ONE = [(a, "tp", None, o, g, cf) for a in ARCHS for o, g, cf in RUNS[a]]
LOSS_TOL, PARAM_TOL, FLAT_TOL = 1e-5, 1e-4, 1e-6


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())

REF_CODE = r"""
import dataclasses, shutil, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models import transformer as T
from repro.train.trainer import Trainer, TrainConfig

root, runs = sys.argv[1], eval(sys.argv[2])
B, S, LR = {B}, {S}, {LR}

def nested(flat):
    out = {{}}
    for k, v in flat.items():
        node = out
        *path, last = k.split("/")
        for seg in path:
            node = node.setdefault(seg, {{}})
        node[last] = v
    return out

def flat(tree):
    return {{"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}}

def mesh(d, m):
    return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))

def ample(cfg, cf):
    return cfg if cfg.moe is None or cf is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))

def trainer(arch, opt, accum, shape, ckpt, cf=8.0):
    with np.load(f"{{root}}/init_{{arch}}.npz") as z:
        init = nested({{k: z[k] for k in z.files}})
    T.init_params = lambda cfg, key: jax.tree.map(jax.numpy.asarray, init)
    tc = TrainConfig(lr=LR, warmup=2, total_steps=10, optimizer=opt,
                     grad_accum=accum, ckpt_dir=ckpt, ckpt_every=4,
                     log_every=100)
    return Trainer(ample(get_smoke_config(arch), cf), tc, mesh(*shape),
                   seq_len=S, global_batch=B)

quiet = dict(log=lambda *a: None)
out = {{}}
if runs == "resume":
    # the port's (2, 2) checkpoint, resumed on (4, 1)
    o = trainer("qwen2_5_3b", "adamw", 1, (4, 1), f"{{root}}/port_ckpt"
                ).fit(6, **quiet)
    out["port_ckpt/losses"] = np.asarray(o["losses"])
else:
    for arch, opt, accum, cf in runs:
        tag = f"{{arch}}-{{opt}}-{{accum}}-{{cf}}"
        o = trainer(arch, opt, accum, (2, 2), f"{{root}}/{{tag}}", cf
                    ).fit(4, **quiet)
        out[tag + "/losses"] = np.asarray(o["losses"])
        for k, v in flat(o["params"]).items():
            out[f"{{tag}}/p/{{k}}"] = v
    # the (2, 2) step-4 checkpoint: one copy for the port, one resumed
    # here on (4, 1)
    src = f"{{root}}/qwen2_5_3b-adamw-1-8.0"
    shutil.copytree(src, f"{{root}}/jax_ckpt")
    o = trainer("qwen2_5_3b", "adamw", 1, (4, 1), src).fit(6, **quiet)
    out["jax_cont/losses"] = np.asarray(o["losses"])
np.savez(f"{{root}}/ref_{{'resume' if runs == 'resume' else 'runs'}}.npz",
         **out)
print("SUBPROCESS_OK")
""".format(B=R.B, S=R.S, LR=R.LR)


def _jax(root, runs):
    """The JAX reference in a subprocess with 4 forced host devices (as
    ``conftest.run_with_devices``), started and returned running."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC)
    return subprocess.Popen([sys.executable, "-c", REF_CODE, str(root),
                             repr(runs)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc, path):
    out, err = proc.communicate(timeout=560)
    assert proc.returncode == 0 and "SUBPROCESS_OK" in out, err[-3000:]
    return dict(np.load(path))


def _init_arrays(root):
    """The JAX package's initial weights of each SMOKE config (seed 0;
    grok's routers x 20), saved for both packages: ``{arch: tree}``."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import transformer as JT
    trees = {}
    for arch in ARCHS:
        params = JT.init_params(get_smoke_config(arch), jax.random.PRNGKey(0))
        flat = {"/".join(str(k.key) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(params)}
        flat = {k: v * np.float32(20.0) if k.endswith("/router") else v
                for k, v in flat.items()}
        np.savez(root / f"init_{arch}.npz", **flat)
        trees[arch] = nest(list(flat), list(flat.values()))
    return trees


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything, once: the JAX runs (in a subprocess) beside the port's
    ranks, then the JAX package resuming the port's checkpoint."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("mesh_train")
    arrays = _init_arrays(root)
    jax_runs = [(a,) + run for a in ARCHS for run in RUNS[a]]
    proc = _jax(root, jax_runs)
    port = R.run_ranks(R.train_ranks, root / "ranks", 4, arrays,
                       CASES + ONE, str(root / "train"))
    ref = _wait(proc, root / "ref_runs.npz")
    ela = R.run_ranks(R.elastic_ranks, root / "elastic_ranks", 4,
                      arrays["qwen2_5_3b"], str(root / "elastic"),
                      str(root / "jax_ckpt"))
    shutil.copytree(root / "elastic" / "a", root / "port_ckpt")
    resumed = _wait(_jax(root, "resume"), root / "ref_resume.npz")
    return dict(port=port, ref=ref, ela=ela, resumed=resumed)


def _tag(case):
    arch, _, _, opt, accum, cf = case
    return f"{arch}-{opt}-{accum}-{cf}"


def _ids(cases):
    return ["-".join(map(str, c)) for c in cases]


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_losses_match_jax_and_one_device(run, case):
    arch, _, _, opt, accum, cf = case
    want = run["ref"][_tag(case) + "/losses"]
    one = run["port"][0][(arch, "tp", None, opt, accum, cf)]["losses"]
    for r, res in enumerate(run["port"]):
        assert res[case]["losses"] == run["port"][0][case]["losses"], r
    got = run["port"][0][case]["losses"]
    assert _rel(got, want) <= LOSS_TOL, (got, want)
    assert _rel(got, one) <= LOSS_TOL, (got, one)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_parameters_match_jax(run, case):
    ref = run["ref"]
    got = run["port"][0][case]["params"]
    prefix = _tag(case) + "/p/"
    keys = sorted(k[len(prefix):] for k in ref if k.startswith(prefix))
    assert sorted(got) == keys
    for k in keys:
        want = ref[prefix + k].astype(np.float64)
        err = np.abs(got[k] - want).max()
        if k.endswith("attn/bk"):
            assert err <= FLAT_TOL, (k, err)
        else:
            assert err <= PARAM_TOL * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_ranks_agree_and_hold_their_shards(run, case):
    """The same checksum of the full parameters on every rank after each
    step (no rank of a model group drifts), and each rank's slot shards
    add up to ``shard_bytes`` of the slots under their specs."""
    port = run["port"]
    for r in range(1, 4):
        assert port[r][case]["sums"] == port[0][case]["sums"], r
    for res in port:
        held, want, _ = res[case]["bytes"]
        assert held == want > 0


def test_mesh_shards_the_optimizer_state(run):
    """On (2, 2) a rank holds its full parameters and less than the full
    AdamW state (two float32 slots a parameter) under every layout, and
    less under ``fsdp`` and ``zero1`` (slots over both axes) than under
    ``tp``."""
    port = run["port"][0]
    held = {lay: port[("qwen2_5_3b", lay, (2, 2), "adamw", 1, 8.0)]["bytes"]
            for lay in LAYOUTS}
    full = sum(v.size * 4 for v in port[ONE[0]]["params"].values())
    for lay, (slots, _, params) in held.items():
        assert params == full and slots < 2 * full, lay
    assert held["fsdp"][0] < held["tp"][0] and held["zero1"][0] < held["tp"][0]


def test_capacity_drops_tokens_in_the_drop_cases(run):
    """At grok-1's own capacity factor the JAX trainer's losses differ
    from those at capacity factor 8: the cases of ``DROPS`` drop tokens,
    and the port drops the same ones on every mesh."""
    ref = run["ref"]
    arch, opt, accum, _ = DROPS
    drop = ref[f"{arch}-{opt}-{accum}-None/losses"]
    ample = ref[f"{arch}-{opt}-{accum}-8.0/losses"]
    assert _rel(drop, ample) > 10 * LOSS_TOL


def test_resume_on_the_same_mesh_is_bit_exact(run):
    for res in run["ela"]:
        assert res["run_b"] == res["run_a"][2:]
        assert res["state_equal"]


def test_jax_checkpoint_resumes_on_another_mesh(run):
    want = run["ref"]["jax_cont/losses"]
    for res in run["ela"]:
        assert _rel(res["from_jax"], want) <= LOSS_TOL


def test_port_checkpoint_resumes_in_jax_on_another_mesh(run):
    want = run["resumed"]["port_ckpt/losses"]
    res = run["ela"][0]
    assert len(want) == 2
    assert _rel(res["port_cont"], want) <= LOSS_TOL
    assert _rel(res["one_cont"], want) <= LOSS_TOL


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_under_torchrun_environment(tmp_path):
    """``launch.train`` with ``WORLD_SIZE`` 4 and ``--model 2`` trains on
    (2, 2): every rank the same losses, within 1e-5 (relative) of one
    device's."""
    from repro_torch.launch import train as launch
    got = R.run_ranks(R.launch_ranks, tmp_path / "ranks", 4, _free_port(),
                      str(tmp_path / "mesh"))
    one = launch.main(["--arch", "qwen2_5_3b", "--smoke", "--steps", "3",
                       "--seq", "16", "--batch", "4", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "one")])["losses"]
    assert all(g == got[0] for g in got) and len(got[0]) == 3
    assert _rel(got[0], one) <= LOSS_TOL


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ranks' tensors on the card)")


@pytest.mark.gpu
def test_mesh_trainer_on_the_card(tmp_path):
    """Four ranks sharing the card through ``gloo`` train qwen2.5-3b's
    SMOKE config on (2, 2) under ``tp``: the same losses on every rank,
    within 1e-5 (relative) of the one-device trainer on the card."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import arrays_from_model
    from repro_torch.models import transformer as T
    arrays = arrays_from_model(T.init_params(get_smoke_config("qwen2_5_3b"),
                                             0, "cpu"))
    cases = [("qwen2_5_3b", "tp", (2, 2), "adamw", 1, 8.0),
             ("qwen2_5_3b", "tp", None, "adamw", 1, 8.0)]
    got = R.run_ranks(R.train_ranks, tmp_path / "ranks", 4,
                      {"qwen2_5_3b": arrays}, cases, str(tmp_path / "t"),
                      device="cuda")
    mesh, one = (got[0][c]["losses"] for c in cases)
    assert all(g[cases[0]]["losses"] == mesh for g in got)
    assert _rel(mesh, one) <= LOSS_TOL
