"""Composable LM-family model definition, in PyTorch.

The port of ``repro/models/transformer.py`` for the serving path: a
*block pattern*, a periodic sequence of mixer kinds ("attn", "mamba"),
each optionally followed by a dense MLP or an MoE FFN.  The JAX package
stacks each weight over the pattern's periods and scans; here
``Model.decoder`` is a list with one entry per period, and a Python loop
runs them.

What waits for later slices: the "mlstm"/"slstm" mixers (the port has no
``models/xlstm.py`` yet) and encoder-decoder models raise
``NotImplementedError``; ``loss_fn``, ``remat`` and the sharding
constraints belong to training and to the distribution slice.
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

__all__ = ["ModelConfig", "Model", "init_params", "forward", "init_cache",
           "decode_step", "param_count"]

_XLSTM = ("the mlstm/slstm mixers wait for the port of models/xlstm.py "
          "(ROADMAP, slice 8)")
_ENC_DEC = ("encoder-decoder models wait for the rest of the LM scaffold "
            "(ROADMAP, slice 8)")


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


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.enc_dec:
        raise NotImplementedError(_ENC_DEC)
    if any(m in ("mlstm", "slstm") for m, _ in cfg.pattern):
        raise NotImplementedError(_XLSTM)


class Model(nn.Module):
    """The weights of one model, under the JAX package's names:
    ``embed``, ``final_norm``, optional ``lm_head``, and ``decoder``, a list
    over periods of ``{"l{i}_mix": {...}, "l{i}_ffn": {...}}``."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = tree["embed"]
        self.final_norm = tree["final_norm"]
        self.decoder = nn.ModuleList(nn.ModuleDict(period)
                                     for period in tree["decoder"])
        self.lm_head = tree.get("lm_head")
        if len(self.decoder) != cfg.n_periods:
            raise ValueError(f"{len(self.decoder)} periods of weights for "
                             f"{cfg.n_periods} in the config")

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.cfg, self, batch)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _mixer_init(gen, cfg: ModelConfig, kind: str) -> nn.ModuleDict:
    dev = gen.device
    norm = L.norm_init(cfg.norm, cfg.d_model, device=dev)
    if kind == "attn":
        return nn.ModuleDict({"norm": norm, "attn": L.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            qkv_bias=cfg.qkv_bias, dtype=cfg.dtype)})
    if kind == "mamba":
        return nn.ModuleDict({"norm": norm, "mamba": SSM.mamba_init(
            gen, cfg.d_model, cfg.ssm, cfg.dtype)})
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
    its weights across instead."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, device=dev),
        "decoder": [
            {**{f"l{i}_mix": _mixer_init(gen, cfg, mix)
                for i, (mix, _) in enumerate(cfg.pattern)},
             **{f"l{i}_ffn": _ffn_init(gen, cfg, ffn)
                for i, (_, ffn) in enumerate(cfg.pattern)}}
            for _ in range(cfg.n_periods)],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.params(w=L.dense_init(
            gen, cfg.d_model, (cfg.d_model, cfg.padded_vocab), cfg.dtype))
    return Model(cfg, tree)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _apply_mixer(cfg: ModelConfig, p, x, kind, *, positions, positions3,
                 kv_cache=None, cache_len=None):
    h = L.apply_norm(cfg.norm, p["norm"], x)
    new_cache = None
    if kind == "attn":
        out, new_kv = L.attention_apply(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, positions=positions, positions3=positions3,
            rope=cfg.rope, rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections, causal=True,
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
        raise NotImplementedError(_XLSTM)
    else:
        raise ValueError(kind)
    return x, new_cache


def _apply_ffn(cfg: ModelConfig, p, x, kind):
    aux = {}
    if kind == "none" or len(p) == 0:
        return x, aux
    h = L.apply_norm(cfg.norm, p["norm"], x)
    if kind == "mlp":
        x = x + L.mlp_apply(p["mlp"], h, act=cfg.act)
    else:
        out, aux = MOE.moe_apply(p["moe"], h, cfg.moe, act=cfg.act)
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
        pe = L.sinusoidal_positions(first_pos + S, cfg.d_model,
                                    tokens.device)[first_pos:]
        x = x + pe[None].to(x.dtype)
    return x, positions, positions3


def forward(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor]):
    """Returns ``(logits, aux_loss)``: float32 logits (B, S, padded_vocab).

    ``batch["tokens"]`` (B, S) integers; for an mrope model optionally
    ``positions3`` (B, S, 3).
    """
    _check_ported(cfg)
    x, positions, positions3 = _embed(cfg, model, batch["tokens"], 0)
    if batch.get("positions3") is not None:
        positions3 = batch["positions3"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in model.decoder:
        for i, (mix, ffn) in enumerate(cfg.pattern):
            x, _ = _apply_mixer(cfg, p[f"l{i}_mix"], x, mix,
                                positions=positions, positions3=positions3)
            x, a = _apply_ffn(cfg, p[f"l{i}_ffn"], x, ffn)
            if "load_balance" in a:
                aux = aux + a["load_balance"]
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    return L.lm_head_apply(model.embed, x, model.lm_head), aux


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None):
    """Decode cache: a list over periods of ``{"l{i}": ...}`` like the
    decoder's weights (zeros; KV buffers of ``max_len`` positions)."""
    _check_ported(cfg)
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
        return sub

    return [one_period() for _ in range(cfg.n_periods)]


def decode_step(cfg: ModelConfig, model: Model, cache, tokens, cur_len: int):
    """One decode step.  ``tokens`` (B, 1) -> ``(logits (B, 1, V),
    new_cache)``; ``cur_len`` is the number of positions already in the
    cache.  The KV buffers are written in place; the SSM states are
    replaced."""
    _check_ported(cfg)
    x, positions, positions3 = _embed(cfg, model, tokens, cur_len)
    new_cache = []
    for p, kv in zip(model.decoder, cache):
        new_kv = {}
        for i, (mix, ffn) in enumerate(cfg.pattern):
            x, new_kv[f"l{i}"] = _apply_mixer(
                cfg, p[f"l{i}_mix"], x, mix, positions=positions,
                positions3=positions3, kv_cache=kv[f"l{i}"],
                cache_len=cur_len)
            x, _ = _apply_ffn(cfg, p[f"l{i}_ffn"], x, ffn)
        new_cache.append(new_kv)
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    return L.lm_head_apply(model.embed, x, model.lm_head), new_cache
