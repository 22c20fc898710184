"""Selective state-space (Mamba/S6) block, the sub-quadratic mixer of the
jamba hybrid architecture, in PyTorch.

The port of ``repro/models/ssm.py``.  The scan over time has three forms
(``SSMConfig.scan_impl``):

* ``"materialized"``: the transition tensors ``dA``/``dBx`` of shape
  (B, S, di, N) are built up front, then scanned;
* ``"chunked"``: they are built per chunk of ``chunk`` timesteps inside
  the scan, never for the whole sequence;
* ``"kernel"``: ``kernels.ops.mamba_scan``, kernel B6 on the card (the
  plain version for CPU tensors).  The JAX package calls this form
  ``"pallas"``.  It pads nothing: the CUDA kernel takes any length, and
  the scan is causal, so the JAX code's padding to a multiple of
  ``chunk`` changes no output.  It serves forward only, in both
  packages: a gradient through it raises.

Under a gradient the first two forms run chunk by chunk of ``chunk``
timesteps, each chunk recomputed in the backward pass (``layers.remat``,
the JAX code's ``jax.checkpoint`` on its chunk body), so the backward
keeps one chunk's per-step states at a time.

Decode is O(1) per token through the carried (conv window, SSM state).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ops import mamba_scan
from repro_torch.models.layers import (dense_init, needs_grad, params,
                                       remat, silu_as)

__all__ = ["SSMConfig", "SCAN_IMPLS", "mamba_init", "mamba_apply",
           "mamba_decode_init", "mamba_decode_step"]

SCAN_IMPLS = ("materialized", "chunked", "kernel")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default d_model // 16
    scan_impl: str = "materialized"   # one of SCAN_IMPLS

    def inner(self, d_model):
        return self.expand * d_model

    def rank(self, d_model):
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


def mamba_init(gen: torch.Generator, d_model, cfg: SSMConfig,
               dtype=torch.bfloat16) -> nn.ParameterDict:
    di = cfg.inner(d_model)
    dr = cfg.rank(d_model)
    N = cfg.d_state
    dev = gen.device
    # S4D-real initialization of A
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(di, N)
    return params(
        in_proj=dense_init(gen, d_model, (d_model, 2 * di), dtype),
        conv_w=dense_init(gen, cfg.d_conv, (cfg.d_conv, di), dtype),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        x_proj=dense_init(gen, di, (di, dr + 2 * N), dtype),
        dt_proj=dense_init(gen, dr, (dr, di), dtype),
        dt_bias=torch.full((di,), -4.6, dtype=torch.float32, device=dev),
        A_log=torch.log(A).contiguous(),
        D=torch.ones((di,), dtype=torch.float32, device=dev),
        out_proj=dense_init(gen, di, (di, d_model), dtype))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` with no linear cut-off
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_params(p, x, cfg: SSMConfig, d_model):
    """Input-dependent (delta, B, C) from the post-conv activations."""
    dr = cfg.rank(d_model)
    N = cfg.d_state
    dbc = x @ p["x_proj"]
    dt, Bc, Cc = torch.split(dbc, [dr, N, N], dim=-1)
    dt = (dt @ p["dt_proj"]).float()
    dt = _softplus(dt + p["dt_bias"])
    return dt, Bc.float(), Cc.float()


def _materialized_chunk(h, dA, dBx):
    """The recurrence over one chunk of the transition tensors: the last
    state and every state (B, chunk, di, N)."""
    hs = []
    for s in range(dA.shape[1]):
        h = dA[:, s] * h + dBx[:, s]
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def _scan_materialized(dt, xc, Bc, Cc, A, chunk):
    dA = torch.exp(dt[..., None] * A)                     # (B, S, di, N)
    dBx = (dt * xc)[..., None] * Bc[:, :, None, :]
    h = torch.zeros_like(dA[:, 0])
    hs = []
    for c0 in range(0, dt.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        h, hk = remat(_materialized_chunk, h, dA[:, sl], dBx[:, sl])
        hs.append(hk)
    return torch.einsum("bsdn,bsn->bsd", torch.cat(hs, dim=1), Cc)


def _chunked_body(h, dt, xc, Bc, Cc, A):
    """One chunk of the chunked scan: the transition tensors of these
    timesteps only, the recurrence, and y (B, chunk, di)."""
    dA = torch.exp(dt[..., None] * A)                     # (B, chunk, di, N)
    dBx = (dt * xc)[..., None] * Bc[:, :, None, :]
    ys = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    return h, torch.stack(ys, dim=1)


def _scan_chunked(dt, xc, Bc, Cc, A, chunk):
    B, S, di = dt.shape
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, y = remat(_chunked_body, h, dt[:, sl], xc[:, sl], Bc[:, sl],
                     Cc[:, sl], A)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _scan_inputs(p, x: torch.Tensor, cfg: SSMConfig):
    """The mixer up to its scan: ``(dt, xc, Bc, Cc, A, z)``, with ``xc``
    the post-conv activations in x's dtype and the rest float32."""
    B, S, d_model = x.shape
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)      # (B, S, di)

    # depthwise causal conv, kernel d_conv, summed in x's dtype in the
    # JAX code's order
    K = cfg.d_conv
    xpad = F.pad(xs, (0, 0, K - 1, 0))
    xc = sum(xpad[:, i:i + S, :] * p["conv_w"][i] for i in range(K)) \
        + p["conv_b"]
    xc = silu_as(xc, x.dtype)

    dt, Bc, Cc = _ssm_params(p, xc, cfg, d_model)         # f32
    A = -torch.exp(p["A_log"])                            # (di, N)
    return dt, xc, Bc, Cc, A, z


def mamba_apply(p, x: torch.Tensor, cfg: SSMConfig, *,
                chunk: int = 256) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model)."""
    if cfg.scan_impl not in SCAN_IMPLS:
        raise ValueError(f"scan_impl must be one of {SCAN_IMPLS}, got "
                         f"{cfg.scan_impl!r}")
    dt, xc, Bc, Cc, A, z = _scan_inputs(p, x, cfg)
    xf = xc.float()
    if cfg.scan_impl == "kernel":
        if needs_grad(dt, xf, Bc, Cc, A):
            raise ValueError(
                "scan_impl='kernel' (B6) serves forward only and takes no "
                "gradient, as in the JAX package; train with "
                "'materialized' or 'chunked'")
        y = mamba_scan(dt, xf, Bc, Cc, A)
    elif cfg.scan_impl == "chunked":
        y = _scan_chunked(dt, xf, Bc, Cc, A, chunk)
    else:
        y = _scan_materialized(dt, xf, Bc, Cc, A, chunk)

    y = y + p["D"] * xf
    y = y.to(x.dtype) * silu_as(z, x.dtype)
    return y @ p["out_proj"]


# ----------------------------------------------------------------- decode
def mamba_decode_init(B, d_model, cfg: SSMConfig, dtype=torch.bfloat16,
                      device=None):
    di = cfg.inner(d_model)
    return {
        "conv": torch.zeros((B, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((B, di, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(p, x: torch.Tensor, state, cfg: SSMConfig):
    """x: (B, 1, d_model); state from ``mamba_decode_init``.  O(1) per
    token; returns ``(out, new_state)``."""
    B, _, d_model = x.shape
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)      # (B, 1, di)

    window = torch.cat([state["conv"], xs], dim=1)        # (B, K, di)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = silu_as(xc, x.dtype)[:, None, :]

    dt, Bc, Cc = _ssm_params(p, xc, cfg, d_model)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)[:, 0]               # (B, di, N)
    dBx = ((dt * xc.float())[..., None] * Bc[:, :, None, :])[:, 0]
    h = dA * state["ssm"] + dBx

    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])
    y = y + p["D"] * xc[:, 0].float()
    y = y.to(x.dtype) * silu_as(z[:, 0], x.dtype)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": window[:, 1:], "ssm": h}
