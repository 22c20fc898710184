"""Core NN layers of the LM scaffold, in PyTorch.

The port of ``repro/models/layers.py``, function for function.  A layer's
weights live in an ``nn.ParameterDict`` under the JAX package's names
(``wq``, ``wk``, ...), made by the ``*_init`` functions from a
``torch.Generator``; the ``*_apply`` functions are plain functions of those
weights and tensors, and round to the working dtype where the JAX code
does.  Weights are built taking no gradient, so serving builds no graph;
the trainer turns gradients on with ``model.requires_grad_(True)``.
``remat`` is ``jax.checkpoint``: a function whose activations are
recomputed in the backward pass instead of kept.

Attention streams over KV blocks with an online softmax (query blocks of
256, KV blocks of ``kv_block``), so no ``(S, S)`` score matrix is formed,
as in the JAX package; it is plain PyTorch products (the JAX package
computes it outside any Pallas kernel too).  Query/KV tile pairs that the
causal mask empties entirely are skipped, which leaves every result bit
for bit as it is.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["dense_init", "params", "rmsnorm_init", "rmsnorm",
           "layernorm_init", "layernorm", "norm_init", "apply_norm",
           "rope_freqs", "apply_rope", "apply_mrope", "sinusoidal_positions",
           "attention_init", "attention_apply", "mlp_init", "mlp_apply",
           "embed_init", "embed_apply", "lm_head_apply", "silu_as",
           "gelu_as", "needs_grad", "remat"]


# ---------------------------------------------------------------------------
# parameters and initializers
# ---------------------------------------------------------------------------

def params(**tensors: torch.Tensor) -> nn.ParameterDict:
    """One layer's weights, by name, as parameters that take no gradient."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


def needs_grad(*tensors, weights=()) -> bool:
    """Whether a gradient flows through a computation on ``tensors`` and
    the parameters ``weights``: gradient mode is on and one of them
    requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    return (any(isinstance(t, torch.Tensor) and t.requires_grad
                for t in tensors)
            or any(w.requires_grad for w in weights))


def remat(fn, *args, weights=()):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``) when a gradient flows through ``args`` or the
    parameters ``weights`` that ``fn`` reads; a plain call otherwise, so
    the serving path is unchanged.  The recomputation repeats the forward
    exactly, so gradients equal those without it."""
    if needs_grad(*args, weights=weights):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device (which
    has none): the init functions read its ``device`` and allocate shapes
    there without drawing."""
    device = torch.device("meta")


def _normal(gen, shape) -> torch.Tensor:
    """Standard normals in float32 from ``gen`` on its device; on ``meta``
    (a :class:`MetaGenerator`) the shape alone."""
    draw = gen if isinstance(gen, torch.Generator) else None
    return torch.randn(tuple(shape), generator=draw, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, fan_in: int, shape,
               dtype) -> torch.Tensor:
    """Normal weights of standard deviation ``1/sqrt(fan_in)``, drawn in
    float32 from ``gen`` on its device, then cast to ``dtype``."""
    return _normal(gen, shape).mul_(1.0 / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d, dtype=torch.float32, device=None) -> nn.ParameterDict:
    return params(scale=torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(p, x: torch.Tensor, eps=1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype=torch.float32, device=None) -> nn.ParameterDict:
    return params(scale=torch.ones((d,), dtype=dtype, device=device),
                  bias=torch.zeros((d,), dtype=dtype, device=device))


def layernorm(p, x: torch.Tensor, eps=1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def norm_init(kind, d, dtype=torch.float32, device=None):
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def apply_norm(kind, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# activations, rounded as the JAX package rounds them
# ---------------------------------------------------------------------------

def silu_as(x: torch.Tensor, dtype) -> torch.Tensor:
    """``silu`` in float32, cast to ``dtype``."""
    return F.silu(x.float()).to(dtype)


def gelu_as(x: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default) in float32, cast to
    ``dtype``."""
    return F.gelu(x.float(), approximate="tanh").to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10000.0):
    """Multimodal RoPE (qwen2-vl): the head_dim/2 frequencies split into
    (temporal, height, width) sections, each rotated by its own position
    component.  positions3: (B, S, 3) integers."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to "
                         f"head_dim/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])
    pos = torch.gather(positions3.float(), -1,
                       sec.expand(*positions3.shape[:2], half))
    return _rotate(x, pos * freqs)


def sinusoidal_positions(S: int, d: int, device=None,
                         start: int = 0) -> torch.Tensor:
    """Rows ``start .. start + S - 1`` of the (positions, d) table."""
    pos = torch.arange(start, start + S, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = torch.zeros((S, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


# ---------------------------------------------------------------------------
# attention (streamed online softmax; GQA)
# ---------------------------------------------------------------------------

def attention_init(gen, d_model, n_heads, n_kv, head_dim, *, qkv_bias=False,
                   dtype=torch.bfloat16) -> nn.ParameterDict:
    dev = gen.device
    p = dict(
        wq=dense_init(gen, d_model, (d_model, n_heads * head_dim), dtype),
        wk=dense_init(gen, d_model, (d_model, n_kv * head_dim), dtype),
        wv=dense_init(gen, d_model, (d_model, n_kv * head_dim), dtype),
        wo=dense_init(gen, n_heads * head_dim,
                      (n_heads * head_dim, d_model), dtype))
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
    return params(**p)


def _online_attn(q, k, v, *, causal: bool, q_offset, kv_len=None,
                 q_block: int = 256, kv_block: int = 512):
    """Streamed attention.  q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D).

    For each query block, a loop over KV blocks carries the running
    (max, denominator, accumulator), so at most a (q_block, kv_block)
    tile of scores exists at once.  q, k and v stay in their dtype; the
    products are taken in float32 (the JAX code asks for float32
    accumulation), and the probabilities are rounded to q's dtype before
    they meet v, as there.  ``q_offset``: the absolute position of q[0];
    ``kv_len``: the valid prefix of the KV buffers.
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qb = min(q_block, Sq)
    kvb = min(kv_block, Skv)
    valid_kv = Skv if kv_len is None else kv_len
    qs = q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, qb):
        qblk = qs[:, q0:q0 + qb].float().reshape(B, -1, Hkv, G, D)
        nq = qblk.shape[1]
        q_pos = q_offset + q0 + torch.arange(nq, device=q.device)
        m = torch.full((B, Hkv, G, nq), -math.inf, device=q.device)
        l = torch.zeros((B, Hkv, G, nq), device=q.device)
        acc = torch.zeros((B, Hkv, G, nq, D), device=q.device)
        for k0 in range(0, Skv, kvb):
            if causal and k0 > q_offset + q0 + nq - 1:
                break                  # the mask empties this tile and the
                                       # rest: they would change nothing
            kv_pos = k0 + torch.arange(min(kvb, Skv - k0), device=q.device)
            mask = kv_pos[None, :] < valid_kv
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            else:
                mask = mask.expand(nq, -1)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                             k[:, k0:k0 + kvb].float())
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype).float(),
                v[:, k0:k0 + kvb].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]   # (B, Hkv, G, nq, D)
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, nq, H, D).to(q.dtype)
    return out


def _direct_attn(q, k, v, *, causal: bool, q_offset, kv_len=None):
    """Unblocked attention for a tiny Sq (decode): one (B, Sq, H, Skv)
    score tensor, in float32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float())
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = kv_pos[None, :] < (Skv if kv_len is None else kv_len)
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    else:
        mask = mask.expand(Sq, Skv)
    s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_apply(p, x, *, n_heads, n_kv, head_dim, positions=None,
                    positions3=None, rope: str = "rope",
                    rope_theta: float = 10000.0, mrope_sections=(16, 24, 24),
                    causal: bool = True,
                    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_len: Optional[int] = None,
                    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_block: int = 1024):
    """GQA attention.  Returns ``(out, new_kv)``: the cache (decode) or the
    fresh K/V (prefill).

    With ``kv_cache`` the new K/V are written into the cache tensors in
    place at ``cache_len`` (the JAX code returns updated copies), and
    ``new_kv`` is that same pair of tensors.
    """
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, n_heads, head_dim)

    if cross_kv is not None:
        k, v = cross_kv
        new_kv = None
        q_offset, kv_len, causal = 0, None, False
    else:
        k = x @ p["wk"]
        vv = x @ p["wv"]
        if "bk" in p:
            k = k + p["bk"]
            vv = vv + p["bv"]
        k = k.reshape(B, S, n_kv, head_dim)
        vv = vv.reshape(B, S, n_kv, head_dim)
        if rope == "rope":
            pos = positions if positions is not None else (
                torch.arange(S, device=x.device)[None, :].expand(B, S))
            q = apply_rope(q, pos, rope_theta)
            k = apply_rope(k, pos, rope_theta)
        elif rope == "mrope":
            if positions3 is None:
                raise ValueError("rope='mrope' needs positions3 (B, S, 3)")
            q = apply_mrope(q, positions3, mrope_sections, rope_theta)
            k = apply_mrope(k, positions3, mrope_sections, rope_theta)
        # (sinusoidal / none: positions handled at the embedding level)

        if kv_cache is not None:
            ck, cv = kv_cache
            ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + S] = vv.to(cv.dtype)
            k, v = ck, cv
            new_kv = (ck, cv)
            q_offset, kv_len = cache_len, cache_len + S
        else:
            v = vv
            new_kv = (k, vv)
            q_offset, kv_len = 0, None

    if S <= 4:       # decode path: direct attention
        out = _direct_attn(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len)
    else:
        out = _online_attn(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, kv_block=kv_block)
    out = out.reshape(B, S, n_heads * head_dim) @ p["wo"]
    return out, new_kv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, *, act="swiglu",
             dtype=torch.bfloat16) -> nn.ParameterDict:
    if act == "swiglu":
        return params(wi=dense_init(gen, d_model, (d_model, d_ff), dtype),
                      wg=dense_init(gen, d_model, (d_model, d_ff), dtype),
                      wo=dense_init(gen, d_ff, (d_ff, d_model), dtype))
    dev = gen.device
    return params(wi=dense_init(gen, d_model, (d_model, d_ff), dtype),
                  wo=dense_init(gen, d_ff, (d_ff, d_model), dtype),
                  bi=torch.zeros((d_ff,), dtype=dtype, device=dev),
                  bo=torch.zeros((d_model,), dtype=dtype, device=dev))


def mlp_apply(p, x, *, act="swiglu"):
    if act == "swiglu":
        h = x @ p["wi"]
        h = silu_as(x @ p["wg"], x.dtype) * h
    else:
        h = gelu_as(x @ p["wi"] + p["bi"], x.dtype)
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# embedding / lm head
# ---------------------------------------------------------------------------

def embed_init(gen, vocab, d_model, dtype=torch.bfloat16) -> nn.ParameterDict:
    t = _normal(gen, (vocab, d_model))
    return params(table=t.mul_(0.02).to(dtype))


def embed_apply(p, tokens):
    return p["table"][tokens]


def lm_head_apply(embed_p, x, head_p=None):
    """Tied (default) or untied LM head; float32 logits."""
    if head_p is not None:
        return (x @ head_p["w"]).float()
    return (x @ embed_p["table"].T).float()
