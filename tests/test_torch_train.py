"""Training in the port (``repro_torch.models.transformer.loss_fn``,
``repro_torch.train``, ``repro_torch.data``) against the JAX package's,
on the CPU.

The JAX package's weights (``init_params`` from a PRNG key) cross over
through ``interop.model_from_arrays``, and both packages take the same
``SyntheticLM`` batch (bit for bit), so both compute the same function;
each architecture's JAX results are computed once, in a module-scoped
fixture.  The two MoE SMOKE models (and jamba's) get routers x 20 and
capacity factor 8, as in ``tests/test_torch_archs.py``, so near-tie
expert choices cannot flip between the frameworks and no token drops.

Tolerances (float32, all ten SMOKE configs):
* the loss and its parts to 1e-5 relative;
* every gradient leaf to ``GRAD_TOL`` of its largest JAX entry: 1e-4,
  and 2e-3 for xLSTM, whose gradients reach 5e-4 (its forward already
  differs by 2.3e-5 of max |logit|; each mLSTM or sLSTM layer alone
  agrees to 5e-6, so this is the depth amplifying float32 round-off);
* one AdamW and one Adafactor step: the updated parameters to
  1e-6 + 50 x lr x the gradient tolerance, where |g| is above 10 x the
  gradient tolerance of its leaf (Adam's first step is about
  lr x sign(g), so where g is at round-off level the packages may step
  in opposite directions; Adafactor's step divides g by a factored RMS,
  so a gradient difference moves it by about lr x that difference over
  the RMS); at least half of every model's entries are compared.
Gradients with remat equal those without it, bit for bit; a resumed run
equals an uninterrupted one, bit for bit.
"""
import dataclasses
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.interop import model_from_arrays
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as XL
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import TrainConfig, Trainer, stack_leaves

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402

ARCHS = configs.list_archs()
B, S, LR = 2, 16, 1e-3
GRAD_TOL = {"xlstm_1_3b": 2e-3}


def _ample(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _sharp_router(params):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x * 20.0 if any(
            getattr(k, "key", None) == "router" for k in p) else x, params)


def _seg(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _flat(tree):
    return {"/".join(_seg(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(cfg):
    b = SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(0)
    if cfg.enc_dec:
        b["enc_embeds"] = np.random.default_rng(1).standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    return b


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _port_trainer(cfg, params, tmp=None, **tc):
    tcfg = TrainConfig(**tc) if tmp is None else TrainConfig(
        ckpt_dir=str(tmp), **tc)
    tr = Trainer(cfg, tcfg, seq_len=S, global_batch=B, device="cpu",
                 init_model=lambda: model_from_arrays(
                     cfg, jax.tree.map(np.asarray, params), "cpu"))
    tr.init_state()
    return tr


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg, cfg = _ample(jax_smoke(arch)), _ample(configs.get_smoke_config(arch))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.moe is not None:
        params = _sharp_router(params)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True)(params)
    steps = {}
    for kind in ("adamw", "adafactor"):
        opt = JOPT.make_optimizer(kind)
        steps[kind], _ = opt.update(grads, opt.init(params), params, LR)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, params=params, batch=batch,
                loss=float(loss), ce=float(metrics["ce"]),
                aux=float(metrics["aux"]), grads=_flat(grads),
                steps={k: _flat(v) for k, v in steps.items()})


def test_loss_and_gradients_match_jax(case):
    tr = _port_trainer(case["cfg"], case["params"])
    loss, metrics, grads = tr.compute_grads(to_device(case["batch"], "cpu"))
    assert float(loss) == pytest.approx(case["loss"], rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(case["ce"], rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(case["aux"], rel=1e-5,
                                                  abs=1e-7)
    assert tr.keys == sorted(case["grads"])
    tol = GRAD_TOL.get(case["arch"], 1e-4)
    for k, g in zip(tr.keys, grads):
        want = case["grads"][k]
        assert g.shape == want.shape and g.dtype == torch.float32, k
        assert np.isfinite(g.numpy()).all(), k
        assert _rel(g.numpy(), want) <= tol, (k, _rel(g.numpy(), want))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_one_optimizer_step_matches_jax(case, kind):
    tr = _port_trainer(case["cfg"], case["params"], optimizer=kind)
    _, _, grads = tr.compute_grads(to_device(case["batch"], "cpu"))
    tr.opt.update(grads, tr.opt_state, tr.params, LR)
    tol = GRAD_TOL.get(case["arch"], 1e-4)
    compared = total = 0
    for k, p in zip(tr.keys, tr.params):
        g = case["grads"][k]
        mask = np.abs(g) > 10 * tol * np.abs(g).max()
        want = case["steps"][kind][k]
        err = np.abs(p.detach().numpy() - want)[mask]
        assert err.size == 0 or err.max() <= 1e-6 + 50 * tol * LR, \
            (k, err.max())
        compared += int(mask.sum())
        total += mask.size
    assert compared >= total / 2, (compared, total)


# ------------------------------------------------------------------- remat
def _no_remat(fn, *args, weights=()):
    return fn(*args)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(arch, monkeypatch):
    """Per-period remat and the mixers' chunk remat recompute the forward
    exactly: the gradients equal those of a run without any remat, bit
    for bit."""
    cfg = _ample(configs.get_smoke_config(arch))
    batch = to_device(_batch(cfg), "cpu")

    def grads():
        model = T.init_params(cfg, 0, "cpu").requires_grad_(True)
        loss, _ = T.loss_fn(cfg, model, batch)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    loss, with_remat = grads()
    for mod in (L, SSM, XL):
        monkeypatch.setattr(mod, "remat", _no_remat)
    loss0, without = grads()
    assert torch.equal(loss, loss0)
    for a, b in zip(with_remat, without):
        assert torch.equal(a, b)


def test_serving_path_builds_no_graph():
    """Without a gradient ``forward`` is the serving path: no checkpoint
    and no graph, even on a model whose weights take a gradient."""
    cfg = configs.get_smoke_config("jamba_1_5_large_398b")
    batch = to_device(_batch(cfg), "cpu")
    model = T.init_params(cfg, 0, "cpu").requires_grad_(True)
    assert not L.needs_grad(torch.ones(1), weights=[torch.ones(1)])
    with torch.no_grad():
        logits, _ = T.forward(cfg, model, batch)
    assert logits.grad_fn is None


def test_router_jitter_draws_nothing_in_the_model():
    """The model passes ``moe_apply`` no generator (as the JAX model
    passes no ``rng``), so router jitter is off in every forward and
    under remat's recompute, whatever ``router_jitter`` says."""
    cfg = _ample(configs.get_smoke_config("grok_1_314b"))
    jit = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.5))
    batch = to_device(_batch(cfg), "cpu")
    out = []
    for c in (cfg, jit):
        model = T.init_params(c, 0, "cpu").requires_grad_(True)
        loss, _ = T.loss_fn(c, model, batch)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_kernel_scan_refuses_a_gradient():
    cfg = configs.get_smoke_config("jamba_1_5_large_398b")
    kern = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, scan_impl="kernel"))
    batch = to_device(_batch(cfg), "cpu")
    model = T.init_params(kern, 0, "cpu")
    logits, _ = T.forward(kern, model, batch)        # serving: fine
    assert logits.shape == (B, S, kern.padded_vocab)
    model.requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        T.loss_fn(kern, model, batch)


@pytest.mark.parametrize("scan_impl", ["materialized", "chunked"])
def test_mamba_training_scans_match(scan_impl):
    """Both training scans of the Mamba mixer, over a sequence of several
    chunks: the same gradients as the other form (float32 round-off)."""
    cfg = SSM.SSMConfig(d_state=4, scan_impl=scan_impl)
    other = dataclasses.replace(cfg, scan_impl="chunked"
                                if scan_impl == "materialized"
                                else "materialized")
    gen = torch.Generator().manual_seed(0)
    p = SSM.mamba_init(gen, 16, cfg, torch.float32).requires_grad_(True)
    x = torch.randn((2, 37, 16), generator=gen)
    out = []
    for c in (cfg, other):
        y = SSM.mamba_apply(p, x, c, chunk=8)
        out.append(torch.autograd.grad(y.square().sum(),
                                       list(p.values())))
    for a, b in zip(*out):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5


# ------------------------------------------------------------------ sLSTM
def _slstm_inputs(dtype, B_=2, S_=7, d=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn((d, 4 * d), generator=g, dtype=dtype) / np.sqrt(d)
    b = torch.randn((4 * d,), generator=g, dtype=dtype) * 0.5
    gx = torch.randn((B_, S_, 4 * d), generator=g, dtype=dtype)
    st = [torch.randn((B_, d), generator=g, dtype=dtype) * 0.3
          for _ in range(3)] + [torch.zeros((B_, d), dtype=dtype)]
    st[2] = st[2].abs() + 0.5                    # a positive normalizer
    return [r, b, gx] + st


def test_slstm_function_passes_gradcheck_in_float64():
    inputs = [t.requires_grad_(True) for t in _slstm_inputs(torch.float64)]
    assert torch.autograd.gradcheck(XL.SLSTMScan.apply, inputs)


def test_slstm_function_equals_the_plain_loop_in_float64():
    """The custom backward against autograd through the plain loop."""
    inputs = [t.requires_grad_(True) for t in _slstm_inputs(torch.float64)]
    g = torch.Generator().manual_seed(3)
    outs = XL.SLSTMScan.apply(*inputs)
    cots = [torch.randn(o.shape, generator=g, dtype=torch.float64)
            for o in outs]
    mine = torch.autograd.grad(outs, inputs, cots)
    st, hs = XL._slstm_loop(inputs[0], inputs[1], inputs[2], inputs[3:])
    plain = torch.autograd.grad((*st, hs), inputs, cots)
    for a, b in zip(mine, plain):
        assert _rel(a.numpy(), b.numpy()) <= 1e-10


def test_slstm_function_matches_the_jax_custom_vjp():
    r, b, gx, h, c, n, m = _slstm_inputs(torch.float32, S_=9, d=8, seed=1)
    g = torch.Generator().manual_seed(4)
    cots = [torch.randn((2, 8), generator=g) for _ in range(4)] + [
        torch.randn((2, 9, 8), generator=g)]
    ins = [t.clone().requires_grad_(True) for t in (r, b, gx, h, c, n, m)]
    outs = XL.SLSTMScan.apply(*ins)
    mine = torch.autograd.grad(outs, ins, cots)

    def j(t):
        return jnp.asarray(t.detach().numpy())
    (jst, jhs), vjp = jax.vjp(JX._slstm_scan_cv, j(r), j(b), j(gx),
                              tuple(j(t) for t in (h, c, n, m)))
    assert _rel(outs[4].detach().numpy(), jhs) <= 1e-6
    dr, db, dgx, dst = vjp((tuple(j(t) for t in cots[:4]), j(cots[4])))
    for got, want in zip(mine, (dr, db, dgx) + tuple(dst)):
        assert _rel(got.numpy(), want) <= 1e-5


def test_slstm_layer_gradients_match_jax():
    """``slstm_apply`` over more than one chunk (the Function per chunk,
    each chunk under remat) against the JAX layer."""
    jcfg, cfg = JX.XLSTMConfig(), XL.XLSTMConfig()
    jp = JX.slstm_init(jax.random.PRNGKey(0), 16, jcfg, jnp.float32)
    p = L.params(**{k: torch.from_numpy(np.asarray(v).copy())
                    for k, v in jp.items()}).requires_grad_(True)
    x = np.random.default_rng(0).standard_normal((2, 21, 16)).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal((2, 21, 16)).astype(
        np.float32)
    jg = jax.grad(lambda q: jnp.sum(JX.slstm_apply(q, jnp.asarray(x), jcfg,
                                                   chunk=8) * w))(jp)
    y = XL.slstm_apply(p, torch.from_numpy(x), cfg, chunk=8)
    gs = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                             list(p.values()))
    for k, got in zip(p.keys(), gs):
        assert _rel(got.numpy(), jg[k]) <= 1e-5, k


# ------------------------------------------------------- trainer and data
def _qwen_trainer(tmp, steps=40, **kw):
    cfg = configs.get_smoke_config("qwen2_5_3b")
    tc = TrainConfig(lr=1e-3, warmup=5, total_steps=steps, ckpt_dir=str(tmp),
                     ckpt_every=5, log_every=100, **kw)
    return Trainer(cfg, tc, seq_len=24, global_batch=4, device="cpu")


def test_loss_descends(tmp_path):
    out = _qwen_trainer(tmp_path).fit(25)
    first = np.mean(out["losses"][:3])
    last = np.mean(out["losses"][-3:])
    assert last < first, (first, last)


def test_kill_and_restart_resumes_exactly(tmp_path):
    """A fresh trainer (a restart after a crash) resumes from the
    checkpoint and continues the same trajectory, bit for bit."""
    out1 = _qwen_trainer(tmp_path).fit(10)      # ckpt at step 10
    assert len(out1["losses"]) == 10
    tr2 = _qwen_trainer(tmp_path)
    out2 = tr2.fit(12)                          # resumes at 10: 10..11
    assert len(out2["losses"]) == 2
    shutil.rmtree(tmp_path)
    tr3 = _qwen_trainer(tmp_path)
    out3 = tr3.fit(12)
    assert out2["losses"] == out3["losses"][10:]
    assert out1["losses"] == out3["losses"][:10]
    for a, b in zip(tr2.params, tr3.params):
        assert torch.equal(a, b)
    for a, b in zip(tr2.opt_state["v"], tr3.opt_state["v"]):
        assert torch.equal(a, b)


def test_trainer_matches_the_jax_trainer(tmp_path):
    """Three steps of the port's trainer against the JAX trainer on the
    same weights and batches (clipping, schedule and AdamW included)."""
    cfg = configs.get_smoke_config("qwen2_5_3b")
    jcfg = jax_smoke("qwen2_5_3b")
    kw = dict(lr=1e-3, warmup=1, total_steps=10, ckpt_every=100,
              log_every=100)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jtr = JTrainer(jcfg, JTrainConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
                   mesh, seq_len=S, global_batch=B)
    jout = jtr.fit(3, log=lambda *_: None)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tr = _port_trainer(cfg, params, tmp_path / "port", **kw)
    out = tr.fit(3, log=lambda *_: None)
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-5)
    assert int(tr.opt_state["count"]) == int(jout["opt_state"]["count"]) == 3
    start = _flat(params)
    want = _flat(jout["params"])
    for k, p in zip(tr.keys, tr.params):
        moved = np.abs(want[k] - start[k]).max()
        assert moved > 0, k
        # every leaf within a tenth of how far the JAX step moved it
        assert np.abs(p.detach().numpy() - want[k]).max() <= 0.1 * moved, k


def test_grad_accum_equals_one_full_batch(tmp_path):
    cfg = configs.get_smoke_config("qwen2_5_3b")
    batch = to_device(SyntheticLM(cfg.vocab_size, 24, 4, seed=3).batch(0),
                      "cpu")
    out = []
    for accum in (1, 2):
        tr = _qwen_trainer(tmp_path, grad_accum=accum)
        tr.init_state()
        loss, metrics, grads = tr.compute_grads(batch)
        out.append((loss, grads))
        assert set(metrics) == {"ce", "aux"}
    assert float(out[1][0]) == pytest.approx(float(out[0][0]), rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert b.dtype == torch.float32
        assert _rel(b.numpy(), a.numpy()) <= 1e-5


def test_straggler_callback_fires(tmp_path, monkeypatch):
    """A step that takes over ``straggler_thresh`` x the step-time EWMA
    calls ``rebalance_cb``.  The trainer's clock is a fake one that each
    step advances by 1 s, and step 7 by 5 s, so the test does not depend
    on how loaded the machine is."""
    clock = [0.0]
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    calls = []
    tr = _qwen_trainer(tmp_path)
    tr.rebalance_cb = lambda step, dt, ewma: calls.append((step, dt, ewma))
    step_fn = tr.train_step

    def timed_step(batch, step):
        clock[0] += 5.0 if step == 7 else 1.0
        return step_fn(batch, step)

    tr.train_step = timed_step
    logs = []
    tr.fit(9, log=logs.append)
    assert calls == [(7, 5.0, pytest.approx(1.4))]
    assert any("straggler step 7" in line for line in logs)


def test_stacked_leaves_share_the_model_weights():
    cfg = configs.get_smoke_config("jamba_1_5_large_398b")
    model = T.init_params(cfg, 0, "cpu")
    keys, leaves, groups = stack_leaves(model)
    k = keys.index("decoder/l4_mix/attn/wq")
    assert leaves[k].shape[0] == cfg.n_periods
    with torch.no_grad():
        leaves[k][0].fill_(0.25)
    assert bool((model.decoder[0]["l4_mix"]["attn"]["wq"] == 0.25).all())
    assert groups[k][1] and not groups[keys.index("embed/table")][1]


def test_batches_are_the_jax_package_batches():
    for seed, step in ((0, 0), (7, 13)):
        mine = SyntheticLM(100, 16, 4, seed=seed).batch(step)
        want = JSyntheticLM(100, 16, 4, seed=seed).batch(step)
        for k in ("tokens", "labels"):
            assert mine[k].dtype == np.int32
            np.testing.assert_array_equal(mine[k], want[k])
    t = to_device(mine, "cpu")
    assert t["tokens"].dtype == torch.int32


def test_deterministic_across_restart():
    b1 = SyntheticLM(100, 16, 4, seed=7).batch(13)
    b2 = SyntheticLM(100, 16, 4, seed=7).batch(13)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_labels_are_shifted_tokens():
    b = SyntheticLM(50, 8, 2, seed=1).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_has_learnable_structure():
    b = SyntheticLM(1000, 512, 8, seed=0, structure=0.5).batch(0)
    t = b["tokens"]
    assert (t[:, 2:] == t[:, :-2]).mean() > 0.3


def test_loss_mask_weights_positions():
    cfg = configs.get_smoke_config("llama3_2_3b")
    model = T.init_params(cfg, 0, "cpu")
    batch = to_device(_batch(cfg), "cpu")
    full, _ = T.loss_fn(cfg, model, batch)
    mask = torch.zeros((B, S))
    mask[:, : S // 2] = 1.0
    half, parts = T.loss_fn(cfg, model, dict(batch, loss_mask=mask))
    logits, _ = T.forward(cfg, model, batch)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    assert float(half) == pytest.approx(float(nll[:, :S // 2].mean()),
                                        rel=1e-6)
    assert float(full) == pytest.approx(float(nll.mean()), rel=1e-6)
    assert set(parts) == {"ce", "aux"}


def test_a_trained_model_serves_without_a_graph(tmp_path):
    tr = _qwen_trainer(tmp_path)
    out = tr.fit(2)
    model = out["params"]
    assert all(p.requires_grad for p in model.parameters())
    prompts = torch.randint(0, tr.cfg.vocab_size, (2, 3),
                            generator=torch.Generator().manual_seed(0))
    gen = serve.generate(tr.cfg, model, prompts, 4)
    assert gen.logits.grad_fn is None and not gen.logits.requires_grad
    assert gen.tokens.shape == (2, 4)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", "llama3_2_3b", "--smoke", "--steps", "4", "--seq",
            "12", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--device", "cpu"]
    out = train.main(argv)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert "final loss" in capsys.readouterr().out
    out = train.main(argv[:4] + ["6"] + argv[5:])
    assert len(out["losses"]) == 2              # resumed at step 4
