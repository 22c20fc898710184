"""Composable LM-family model definition, in PyTorch.

The port of ``repro/models/transformer.py`` for the serving path: a
*block pattern*, a periodic sequence of mixer kinds ("attn", "mamba",
"mlstm", "slstm"), each optionally followed by a dense MLP or an MoE FFN.
The JAX package stacks each weight over the pattern's periods and scans;
here ``Model.decoder`` (and an encoder-decoder model's ``Model.encoder``)
is a list with one entry per period, and a Python loop runs them.

Encoder-decoder (whisper) runs a bidirectional encoder stack over the
stub frontend's frame embeddings (``enc_embeds``) and a decoder stack
whose attention layers also attend to the encoder's states; their K/V
are projected from those states on every call, prefill and decode, as in
the JAX package.

Training: ``loss_fn`` is next-token cross entropy over the padded
vocabulary plus 0.01 times the MoE load-balancing loss.  When a gradient
flows, each period runs under ``layers.remat`` (the JAX code's
``jax.checkpoint`` on its period body), so the backward keeps only each
period's input and recomputes the rest; without a gradient ``forward`` is
the serving path, unchanged.  The sharding constraints wait for the
distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.execution import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

__all__ = ["ModelConfig", "Model", "init_params", "forward", "loss_fn",
           "init_cache", "decode_step", "param_count", "active_param_count"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # block pattern: (mixer, ffn) kinds, length = period; mixer in
    # {"attn","mamba","mlstm","slstm"}; ffn in {"mlp","moe","none"}
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    rope: str = "rope"               # rope|mrope|sinusoidal|none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = True
    moe: Optional[MOE.MoEConfig] = None
    ssm: SSM.SSMConfig = SSM.SSMConfig()
    xlstm: XL.XLSTMConfig = XL.XLSTMConfig()
    enc_dec: bool = False
    n_enc_layers: int = 0            # encoder stack depth (enc_dec only)
    dec_len_ratio: int = 8           # S_dec = S / ratio for enc-dec cells
    dtype: Any = torch.bfloat16
    vocab_pad: int = 256
    max_position: int = 1 << 20

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        v, p = self.vocab_size, self.vocab_pad
        return ((v + p - 1) // p) * p

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period != 0:
            raise ValueError(f"n_layers={self.n_layers} not a multiple of "
                             f"the layer pattern period {self.period}")
        return self.n_layers // self.period

    def full_pattern(self) -> List[Tuple[str, str]]:
        return list(self.pattern) * self.n_periods

    @property
    def sub_quadratic(self) -> bool:
        mixers = {m for m, _ in self.pattern}
        return "attn" not in mixers or mixers & {"mamba", "mlstm", "slstm"}


def n_enc_periods(cfg: ModelConfig) -> int:
    """The encoder stack's periods (encoder-decoder models)."""
    if cfg.n_enc_layers % cfg.period != 0:
        raise ValueError(
            f"n_enc_layers={cfg.n_enc_layers} not a multiple of the "
            f"layer pattern period {cfg.period}")
    return cfg.n_enc_layers // cfg.period


def _stack(periods, want: int, name: str) -> nn.ModuleList:
    stack = nn.ModuleList(nn.ModuleDict(period) for period in periods)
    if len(stack) != want:
        raise ValueError(f"{len(stack)} periods of {name} weights for "
                         f"{want} in the config")
    return stack


class Model(nn.Module):
    """The weights of one model, under the JAX package's names:
    ``embed``, ``final_norm``, optional ``lm_head``, and ``decoder``, a list
    over periods of ``{"l{i}_mix": {...}, "l{i}_ffn": {...}}``; an
    encoder-decoder model also has ``encoder`` (a list like ``decoder``,
    over ``n_enc_layers // period`` periods) and ``enc_norm``."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.embed = tree["embed"]
        self.final_norm = tree["final_norm"]
        self.decoder = _stack(tree["decoder"], cfg.n_periods, "decoder")
        self.lm_head = tree.get("lm_head")
        self.encoder = self.enc_norm = None
        if cfg.enc_dec:
            self.encoder = _stack(tree["encoder"], n_enc_periods(cfg),
                                  "encoder")
            self.enc_norm = tree["enc_norm"]

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.cfg, self, batch)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attention_init(gen, cfg: ModelConfig):
    return L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, qkv_bias=cfg.qkv_bias, dtype=cfg.dtype)


def _mixer_init(gen, cfg: ModelConfig, kind: str,
                cross: bool = False) -> nn.ModuleDict:
    """One mixer's weights; ``cross``: an attention layer of an
    encoder-decoder model's decoder, which also carries ``xnorm`` and
    ``xattn`` (its cross-attention)."""
    dev = gen.device
    norm = L.norm_init(cfg.norm, cfg.d_model, device=dev)
    if kind == "attn":
        p = {"norm": norm, "attn": _attention_init(gen, cfg)}
        if cross:
            p["xnorm"] = L.norm_init(cfg.norm, cfg.d_model, device=dev)
            p["xattn"] = _attention_init(gen, cfg)
        return nn.ModuleDict(p)
    if kind == "mamba":
        return nn.ModuleDict({"norm": norm, "mamba": SSM.mamba_init(
            gen, cfg.d_model, cfg.ssm, cfg.dtype)})
    if kind == "mlstm":
        return nn.ModuleDict({"norm": norm, "mlstm": XL.mlstm_init(
            gen, cfg.d_model, cfg.xlstm, cfg.dtype)})
    if kind == "slstm":
        return nn.ModuleDict({"norm": norm, "slstm": XL.slstm_init(
            gen, cfg.d_model, cfg.xlstm, cfg.dtype)})
    raise ValueError(kind)


def _ffn_init(gen, cfg: ModelConfig, kind: str) -> nn.ModuleDict:
    if kind == "none":
        return nn.ModuleDict()
    norm = L.norm_init(cfg.norm, cfg.d_model, device=gen.device)
    if kind == "mlp":
        return nn.ModuleDict({"norm": norm, "mlp": L.mlp_init(
            gen, cfg.d_model, cfg.d_ff, act=cfg.act, dtype=cfg.dtype)})
    if kind == "moe":
        if cfg.moe is None:
            raise ValueError("ffn kind 'moe' needs cfg.moe")
        return nn.ModuleDict({"norm": norm, "moe": MOE.moe_init(
            gen, cfg.d_model, cfg.d_ff, cfg.moe, act=cfg.act,
            dtype=cfg.dtype)})
    raise ValueError(kind)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the card).  The draws differ from the JAX
    package's ``jax.random`` ones; ``interop.model_from_arrays`` carries
    its weights across instead.  On ``device="meta"`` the weights are
    shapes and dtypes only (the JAX package's ``eval_shape``): nothing is
    drawn or allocated."""
    dev = resolve_device(device)
    gen = (L.MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))

    def stack(n_periods, cross):
        return [{**{f"l{i}_mix": _mixer_init(gen, cfg, mix, cross)
                    for i, (mix, _) in enumerate(cfg.pattern)},
                 **{f"l{i}_ffn": _ffn_init(gen, cfg, ffn)
                    for i, (_, ffn) in enumerate(cfg.pattern)}}
                for _ in range(n_periods)]

    tree: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, device=dev),
        "decoder": stack(cfg.n_periods, cross=cfg.enc_dec),
    }
    if cfg.enc_dec:
        tree["encoder"] = stack(n_enc_periods(cfg), cross=False)
        tree["enc_norm"] = L.norm_init(cfg.norm, cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.params(w=L.dense_init(
            gen, cfg.d_model, (cfg.d_model, cfg.padded_vocab), cfg.dtype))
    return Model(cfg, tree)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ModelConfig, model: nn.Module) -> int:
    """Parameters touched per token: an MoE FFN's expert weights (``wi``,
    ``wg``, ``wo`` under ``moe``) count top_k / n_experts of their size."""
    total = param_count(model)
    if cfg.moe is None:
        return total
    moe = sum(p.numel() for name, p in model.named_parameters()
              if "moe" in name.split(".")[:-1]
              and name.rsplit(".", 1)[-1] in ("wi", "wg", "wo"))
    return total - moe + moe * cfg.moe.top_k // cfg.moe.n_experts


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _apply_mixer(cfg: ModelConfig, p, x, kind, *, positions, positions3,
                 causal=True, kv_cache=None, cache_len=None):
    h = L.apply_norm(cfg.norm, p["norm"], x)
    new_cache = None
    if kind == "attn":
        out, new_kv = L.attention_apply(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, positions=positions, positions3=positions3,
            rope=cfg.rope, rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections, causal=causal,
            kv_cache=None if kv_cache is None else kv_cache["self"],
            cache_len=cache_len)
        x = x + out
        new_cache = {"self": new_kv}
    elif kind == "mamba":
        if kv_cache is None:
            x = x + SSM.mamba_apply(p["mamba"], h, cfg.ssm)
        else:
            out, st = SSM.mamba_decode_step(p["mamba"], h, kv_cache["ssm"],
                                            cfg.ssm)
            x = x + out
            new_cache = {"ssm": st}
    elif kind in ("mlstm", "slstm"):
        apply, step = ((XL.mlstm_apply, XL.mlstm_decode_step)
                       if kind == "mlstm" else
                       (XL.slstm_apply, XL.slstm_decode_step))
        if kv_cache is None:
            x = x + apply(p[kind], h, cfg.xlstm)
        else:
            out, st = step(p[kind], h, kv_cache[kind], cfg.xlstm)
            x = x + out
            new_cache = {kind: st}
    else:
        raise ValueError(kind)
    return x, new_cache


def _cross_attend(cfg: ModelConfig, p, x, enc):
    """``x`` plus its cross-attention (``p["xattn"]``) to the encoder's
    states ``enc`` (B, S_enc, d), whose K/V are projected here."""
    B, Se = enc.shape[:2]
    shape = (B, Se, cfg.n_kv_heads, cfg.hd)
    k = (enc @ p["xattn"]["wk"]).reshape(shape)
    v = (enc @ p["xattn"]["wv"]).reshape(shape)
    hx = L.apply_norm(cfg.norm, p["xnorm"], x)
    out, _ = L.attention_apply(
        p["xattn"], hx, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, rope="none", causal=False, cross_kv=(k, v))
    return x + out


def _apply_ffn(cfg: ModelConfig, p, x, kind, rows=None):
    aux = {}
    if kind == "none" or len(p) == 0:
        return x, aux
    h = L.apply_norm(cfg.norm, p["norm"], x)
    if kind == "mlp":
        x = x + L.mlp_apply(p["mlp"], h, act=cfg.act)
    else:
        out, aux = MOE.moe_apply(p["moe"], h, cfg.moe, act=cfg.act,
                                 rows=rows)
        x = x + out
    return x, aux


def _embed(cfg: ModelConfig, model: Model, tokens, first_pos: int):
    """Embeddings of ``tokens`` (B, S) at positions ``first_pos ...``, and
    the positions the mixers need."""
    B, S = tokens.shape
    x = L.embed_apply(model.embed, tokens)
    positions = (first_pos + torch.arange(S, dtype=torch.int32,
                                          device=tokens.device)).expand(B, S)
    positions3 = None
    if cfg.rope == "mrope":
        positions3 = positions[..., None].expand(B, S, 3)
    if cfg.rope == "sinusoidal":
        # only the rows of these positions (the JAX decode builds the
        # table's max_position rows on every step)
        pe = L.sinusoidal_positions(S, cfg.d_model, tokens.device,
                                    start=first_pos)
        x = x + pe[None].to(x.dtype)
    return x, positions, positions3


def _run_period(cfg: ModelConfig, p, x, aux, causal, positions,
                positions3, enc, rows):
    """One period of the pattern over ``x``; ``aux`` accumulates the
    load-balancing losses."""
    for i, (mix, ffn) in enumerate(cfg.pattern):
        pm = p[f"l{i}_mix"]
        x, _ = _apply_mixer(cfg, pm, x, mix, positions=positions,
                            positions3=positions3, causal=causal)
        if enc is not None and "xattn" in pm:
            x = _cross_attend(cfg, pm, x, enc)
        x, a = _apply_ffn(cfg, p[f"l{i}_ffn"], x, ffn, rows)
        if "load_balance" in a:
            aux = aux + a["load_balance"]
    return x, aux


def _run_stack(cfg: ModelConfig, stack, x, *, causal, positions,
               positions3, enc=None, rows=None):
    """The periods of ``stack`` over ``x``; with ``enc``, each attention
    layer that has a cross-attention attends to those encoder states;
    ``rows`` goes to the MoE layers (``moe.RowShare``).
    Each period is recomputed in the backward pass when a gradient flows
    (``layers.remat``).  Returns ``(x, summed load-balancing loss)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in stack:
        def period(x, aux, enc, p=p):
            return _run_period(cfg, p, x, aux, causal, positions,
                               positions3, enc, rows)
        x, aux = L.remat(period, x, aux, enc, weights=p.parameters())
    return x, aux


def encode(cfg: ModelConfig, model: Model, enc_embeds: torch.Tensor,
           rows=None):
    """The encoder of an encoder-decoder model: sinusoidal positions
    added to the frontend's frame embeddings (B, S_enc, d), the
    bidirectional stack, ``enc_norm``.  Returns ``(states, aux_loss)``."""
    e = enc_embeds.to(cfg.dtype)
    e = e + L.sinusoidal_positions(e.shape[1], cfg.d_model,
                                   e.device)[None].to(e.dtype)
    e, aux = _run_stack(cfg, model.encoder, e, causal=False,
                        positions=None, positions3=None, rows=rows)
    return L.apply_norm(cfg.norm, model.enc_norm, e), aux


def forward(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
            rows=None):
    """Returns ``(logits, aux_loss)``: float32 logits (B, S, padded_vocab).

    ``batch["tokens"]`` (B, S) integers, the decoder's tokens; for an
    encoder-decoder model also ``enc_embeds`` (B, S_enc, d), the stub
    frontend's output; for an mrope model optionally ``positions3``
    (B, S, 3).  ``rows`` (``moe.RowShare``): the batch is this rank's
    rows of a global batch split over ranks, for the MoE layers.
    """
    x, positions, positions3 = _embed(cfg, model, batch["tokens"], 0)
    if batch.get("positions3") is not None:
        positions3 = batch["positions3"]
    enc, aux = None, 0.0
    if cfg.enc_dec:
        enc, aux = encode(cfg, model, batch["enc_embeds"], rows)
    x, aux_d = _run_stack(cfg, model.decoder, x, causal=True,
                          positions=positions, positions3=positions3,
                          enc=enc, rows=rows)
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    return L.lm_head_apply(model.embed, x, model.lm_head), aux_d + aux


def loss_fn(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
            rows=None):
    """Next-token cross entropy over the padded vocabulary (+ 0.01 x the
    MoE load-balancing loss).  ``batch["labels"]`` (B, S) integers;
    optional ``batch["loss_mask"]`` (B, S) weights the positions.
    Returns ``(loss, {"ce": cross entropy, "aux": load-balancing loss})``,
    as the JAX package's ``loss_fn``.  ``rows`` as in :func:`forward`."""
    logits, aux = forward(cfg, model, batch, rows)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    loss = nll.sum() / denom
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None,
               enc_len: int = 0):
    """Decode cache: a list over periods of ``{"l{i}": ...}`` like the
    decoder's weights (zeros; KV buffers of ``max_len`` positions, the
    recurrent mixers' states).  ``enc_len`` is taken and unused, as in the
    JAX package: no cross-attention K/V are cached (``decode_step``
    projects them from ``enc_out``)."""
    dev = resolve_device(device)

    def one_period():
        sub = {}
        for i, (mix, _) in enumerate(cfg.pattern):
            if mix == "attn":
                shape = (B, max_len, cfg.n_kv_heads, cfg.hd)
                sub[f"l{i}"] = {"self": (
                    torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    torch.zeros(shape, dtype=cfg.dtype, device=dev))}
            elif mix == "mamba":
                sub[f"l{i}"] = {"ssm": SSM.mamba_decode_init(
                    B, cfg.d_model, cfg.ssm, cfg.dtype, dev)}
            elif mix == "mlstm":
                sub[f"l{i}"] = {"mlstm": XL.mlstm_decode_init(
                    B, cfg.d_model, cfg.xlstm, dev)}
            elif mix == "slstm":
                sub[f"l{i}"] = {"slstm": XL.slstm_decode_init(
                    B, cfg.d_model, cfg.xlstm, dev)}
        return sub

    return [one_period() for _ in range(cfg.n_periods)]


def decode_step(cfg: ModelConfig, model: Model, cache, tokens, cur_len: int,
                enc_out=None):
    """One decode step.  ``tokens`` (B, 1) -> ``(logits (B, 1, V),
    new_cache)``; ``cur_len`` is the number of positions already in the
    cache.  For an encoder-decoder model pass the encoder's states
    ``enc_out`` (B, S_enc, d); without them its cross-attention is
    skipped, as in the JAX package.  The KV buffers are written in place;
    the recurrent states are replaced."""
    x, positions, positions3 = _embed(cfg, model, tokens, cur_len)
    new_cache = []
    for p, kv in zip(model.decoder, cache):
        new_kv = {}
        for i, (mix, ffn) in enumerate(cfg.pattern):
            pm = p[f"l{i}_mix"]
            x, new_kv[f"l{i}"] = _apply_mixer(
                cfg, pm, x, mix, positions=positions,
                positions3=positions3, kv_cache=kv[f"l{i}"],
                cache_len=cur_len)
            if enc_out is not None and "xattn" in pm:
                x = _cross_attend(cfg, pm, x, enc_out)
            x, _ = _apply_ffn(cfg, p[f"l{i}_ffn"], x, ffn)
        new_cache.append(new_kv)
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    return L.lm_head_apply(model.embed, x, model.lm_head), new_cache
