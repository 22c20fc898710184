"""xLSTM blocks (arXiv:2405.04517), in PyTorch: mLSTM (matrix memory) and
sLSTM (scalar memory, strictly recurrent), interleaved 7:1 in the
xlstm-1.3b configuration.

The port of ``repro/models/xlstm.py``: forward, decode and training.
It rounds where the JAX code rounds: ``k / sqrt(dh)`` in k's dtype, the
gates from ``xm`` in float32, the states (C, n, m) in float32, ``h``
cast to x's dtype before the ``skip_scale`` add, ``silu`` in float32
then cast.  Under a gradient every scan runs chunk by chunk, each chunk
recomputed in the backward pass (``layers.remat``, the JAX code's
``jax.checkpoint`` on its chunk bodies).  The sLSTM scan is a
``torch.autograd.Function`` whose backward is the JAX package's custom
VJP: it recomputes the per-step input states, runs the steps in reverse
for each step's gate pre-activation gradient, and forms the recurrent
weight's and the bias's gradients with one reduction each after the loop.

The recurrent mLSTM (``XLSTMConfig.chunkwise=False``, the FULL config's
path) is a Python loop over time; each step reads and writes the
(B, H, dh, dh) matrix memory.  The chunkwise form touches it once per
chunk of ``chunk`` steps.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models.layers import dense_init, params, remat, silu_as
from repro_torch.models.ssm import _softplus

__all__ = ["XLSTMConfig", "mlstm_init", "mlstm_apply", "mlstm_decode_init",
           "mlstm_decode_step", "slstm_init", "slstm_apply",
           "slstm_decode_init", "slstm_decode_step", "SLSTMScan"]


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    expand: int = 2          # mLSTM up-projection factor
    slstm_every: int = 8     # every k-th block is sLSTM (7:1 ratio)
    chunk: int = 256
    chunkwise: bool = False  # chunkwise-parallel mLSTM (matmul form; the
                             # state is touched once per chunk)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -_softplus(-x)


# ---------------------------------------------------------------- mLSTM
def mlstm_init(gen: torch.Generator, d_model, cfg: XLSTMConfig,
               dtype=torch.bfloat16) -> nn.ParameterDict:
    di = cfg.expand * d_model
    H = cfg.n_heads
    dev = gen.device
    return params(
        up=dense_init(gen, d_model, (d_model, 2 * di), dtype),
        wq=dense_init(gen, di, (di, di), dtype),
        wk=dense_init(gen, di, (di, di), dtype),
        wv=dense_init(gen, di, (di, di), dtype),
        wi=dense_init(gen, di, (di, H), torch.float32),
        wf=dense_init(gen, di, (di, H), torch.float32),
        bi=torch.zeros((H,), dtype=torch.float32, device=dev),
        bf=torch.full((H,), 3.0, dtype=torch.float32, device=dev),
        down=dense_init(gen, di, (di, d_model), dtype),
        skip_scale=torch.ones((di,), dtype=dtype, device=dev))


def _mlstm_heads(p, x, cfg: XLSTMConfig, d_model):
    di = cfg.expand * d_model
    H = cfg.n_heads
    dh = di // H
    B, S = x.shape[:2]
    xm, z = torch.chunk(x @ p["up"], 2, dim=-1)          # (B, S, di)
    q = (xm @ p["wq"]).reshape(B, S, H, dh)
    k = (xm @ p["wk"]).reshape(B, S, H, dh)
    v = (xm @ p["wv"]).reshape(B, S, H, dh)
    k = k / torch.sqrt(torch.tensor(dh, dtype=k.dtype))
    xf = xm.float()
    logi = xf @ p["wi"] + p["bi"]                        # (B, S, H) f32
    logf = _log_sigmoid(xf @ p["wf"] + p["bf"])
    return xm, z, q, k, v, logi, logf


def _mlstm_step(C, n, m, q, k, v, logi, logf):
    """One recurrent step.  C (B, H, dh, dh), n (B, H, dh), m (B, H) in
    float32; q, k, v (B, H, dh); logi, logf (B, H).  Returns the new
    state and h (B, H, dh) in float32."""
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)
    f_ = torch.exp(logf + m - m_new)
    kf, vf = k.float(), v.float()
    C = torch.addcmul(f_[..., None, None] * C, (i_[..., None] * kf)[..., None],
                      vf[..., None, :])
    n = f_[..., None] * n + i_[..., None] * kf
    qf = q.float()
    num = torch.matmul(qf[..., None, :], C)[..., 0, :]
    den = torch.abs(torch.sum(qf * n, dim=-1))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return C, n, m_new, h


def _pad_time(a: torch.Tensor, Sp: int, fill: float) -> torch.Tensor:
    """``a`` (B, S, ...) padded along time to ``Sp`` steps with ``fill``."""
    if a.shape[1] == Sp:
        return a
    pad = torch.full((a.shape[0], Sp - a.shape[1]) + a.shape[2:], fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=1)


def _state0(B, H, dh, device):
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H), dtype=torch.float32, device=device))


def _mlstm_chunk(C, n, m, q, k, v, logi, logf):
    """The recurrent steps of one chunk: the state after it and h
    (B, chunk, H, dh) in float32."""
    hs = []
    for t in range(q.shape[1]):
        C, n, m, h = _mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t],
                                 logi[:, t], logf[:, t])
        hs.append(h)
    return C, n, m, torch.stack(hs, dim=1)


def _mlstm_recurrent(q, k, v, logi, logf, chunk: int):
    """The JAX package's recurrent scan: time padded to a multiple of
    ``chunk`` (padded steps take logi = -30 and logf = 0, so they add
    about nothing and leave the state as it was), then one step at a
    time, chunk by chunk.  Returns h (B, S, H, dh) in float32."""
    B, S, H, dh = q.shape
    Sp = -(-S // chunk) * chunk
    q, k, v = (_pad_time(a, Sp, 0.0) for a in (q, k, v))
    logi, logf = _pad_time(logi, Sp, -30.0), _pad_time(logf, Sp, 0.0)
    C, n, m = _state0(B, H, dh, q.device)
    hs = []
    for c0 in range(0, Sp, chunk):
        sl = slice(c0, c0 + chunk)
        C, n, m, h = remat(_mlstm_chunk, C, n, m, q[:, sl], k[:, sl],
                           v[:, sl], logi[:, sl], logf[:, sl])
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S]


def _chunkwise_body(C, n, m, qk, kk, vk, lik, lfk):
    """One chunk of W steps of the chunkwise mLSTM: the state at its end
    and h (B, W, H, dh) in float32."""
    W = qk.shape[1]
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=qk.device))
    qk, kk, vk = qk.float(), kk.float(), vk.float()
    # cumulative log forget within the chunk: F[t] = sum_{s<=t} logf[s]
    F = torch.cumsum(lfk, dim=1)                          # (B, W, H)
    Ftot = F[:, -1]                                       # (B, H)
    log_inter = F + m[:, None]
    log_src = lik - F
    m_t = torch.maximum(log_inter, F + torch.cummax(log_src, dim=1).values)
    # D[t, s] = exp(F[t] - F[s] + logi[s] - m_t)   (s <= t)
    logD = (F[:, :, None, :] - F[:, None, :, :]
            + lik[:, None, :, :] - m_t[:, :, None, :])    # (B, t, s, H)
    Dm = torch.where(tri[None, :, :, None], torch.exp(logD), 0.0)
    s_qk = torch.einsum("bthd,bshd->btsh", qk, kk)
    h_intra = torch.einsum("btsh,bshd->bthd", s_qk * Dm, vk)
    n_intra = torch.einsum("btsh,bshd->bthd", Dm, kk)
    scale_t = torch.exp(log_inter - m_t)                  # (B, W, H)
    h_inter = torch.einsum("bthd,bhde->bthe", qk, C) * scale_t[..., None]
    n_inter = n[:, None] * scale_t[..., None]
    den = torch.abs(torch.einsum("bthd,bthd->bth", qk, n_intra + n_inter))
    h = (h_intra + h_inter) / torch.maximum(den, torch.exp(-m_t))[..., None]
    # the state at the end of the chunk
    m_new = torch.maximum(Ftot + m,
                          torch.amax(log_src + Ftot[:, None], dim=1))
    w_src = torch.exp(Ftot[:, None] + log_src - m_new[:, None])  # (B, W, H)
    decay = torch.exp(Ftot + m - m_new)
    C = decay[..., None, None] * C + torch.einsum(
        "bshd,bshe->bhde", w_src[..., None] * kk, vk)
    n = decay[..., None] * n + torch.einsum("bsh,bshd->bhd", w_src, kk)
    return C, n, m_new, h


def _mlstm_chunkwise(q, k, v, logi, logf, chunk: int):
    """Chunkwise-parallel mLSTM: carries (C, n, m) across chunks of W
    steps and handles each chunk's inside with masked products, touching
    the state once per chunk.  q, k, v: (B, S, H, dh) (k pre-scaled);
    logi, logf: (B, S, H).  Returns h (B, S, H, dh) in float32, equal to
    the recurrent form to float32 round-off."""
    B, S, H, dh = q.shape
    W = min(chunk, S)
    Sp = -(-S // W) * W
    q, k, v = (_pad_time(a, Sp, 0.0) for a in (q, k, v))
    logi, logf = _pad_time(logi, Sp, -30.0), _pad_time(logf, Sp, 0.0)
    C, n, m = _state0(B, H, dh, q.device)
    hs = []
    for c0 in range(0, Sp, W):
        sl = slice(c0, c0 + W)
        C, n, m, h = remat(_chunkwise_body, C, n, m, q[:, sl], k[:, sl],
                           v[:, sl], logi[:, sl], logf[:, sl])
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S]


def _mlstm_out(p, hs, xm, z, x_dtype):
    """h (B, S, di) float32 -> the block's output (B, S, d_model)."""
    h = hs.to(x_dtype) + p["skip_scale"] * xm
    h = h * silu_as(z, x_dtype)
    return h @ p["down"]


def mlstm_apply(p, x: torch.Tensor, cfg: XLSTMConfig) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model)."""
    B, S, d_model = x.shape
    xm, z, q, k, v, logi, logf = _mlstm_heads(p, x, cfg, d_model)
    if cfg.chunkwise:
        hs = _mlstm_chunkwise(q, k, v, logi, logf, cfg.chunk)
    else:
        hs = _mlstm_recurrent(q, k, v, logi, logf, min(cfg.chunk, S))
    return _mlstm_out(p, hs.reshape(B, S, -1), xm, z, x.dtype)


def mlstm_decode_init(B, d_model, cfg: XLSTMConfig, device=None):
    di = cfg.expand * d_model
    C, n, m = _state0(B, cfg.n_heads, di // cfg.n_heads, device)
    return {"C": C, "n": n, "m": m}


def mlstm_decode_step(p, x: torch.Tensor, state, cfg: XLSTMConfig):
    """x: (B, 1, d_model); returns ``(out (B, 1, d_model), new_state)``."""
    B, _, d_model = x.shape
    xm, z, q, k, v, logi, logf = _mlstm_heads(p, x, cfg, d_model)
    C, n, m, h = _mlstm_step(state["C"], state["n"], state["m"], q[:, 0],
                             k[:, 0], v[:, 0], logi[:, 0], logf[:, 0])
    out = _mlstm_out(p, h.reshape(B, 1, -1), xm, z, x.dtype)
    return out, {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------- sLSTM
def slstm_init(gen: torch.Generator, d_model, cfg: XLSTMConfig,
               dtype=torch.bfloat16) -> nn.ParameterDict:
    dev = gen.device
    f32 = torch.float32
    return params(
        wx=dense_init(gen, d_model, (d_model, 4 * d_model), dtype),
        r=dense_init(gen, d_model, (d_model, 4 * d_model), f32),
        b=torch.cat([torch.zeros((2 * d_model,), dtype=f32, device=dev),
                     torch.full((d_model,), 3.0, dtype=f32, device=dev),
                     torch.zeros((d_model,), dtype=f32, device=dev)]),
        out=dense_init(gen, d_model, (d_model, d_model), dtype))


def _slstm_cell(pre, st):
    """One sLSTM cell given gate pre-activations.  pre: (B, 4, d)."""
    h, c, n, m = st
    zt = torch.tanh(pre[:, 0])
    logi = pre[:, 1]
    logf = _log_sigmoid(pre[:, 2])
    ot = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)
    f_ = torch.exp(logf + m - m_new)
    c = f_ * c + i_ * zt
    n = f_ * n + i_
    h_new = ot * c / torch.clamp(n, min=1e-6)
    return (h_new, c, n, m_new)


def _slstm_loop(r, b, gx, st):
    """The plain sLSTM scan.  r (d, 4d), b (4d,); gx: (B, S, 4d) input
    contributions; st: (h, c, n, m), each (B, d), in the states' dtype
    (float32 in the model).  Returns the last state and h (B, S, d) in
    that dtype."""
    B, S = gx.shape[:2]
    d = gx.shape[2] // 4
    dt = st[0].dtype
    bb = b.reshape(4, d)
    hs = torch.empty((B, S, d), dtype=dt, device=gx.device)
    for t in range(S):
        rec = (st[0] @ r).reshape(B, 4, d)
        st = _slstm_cell(gx[:, t].to(dt).reshape(B, 4, d) + rec + bb, st)
        hs[:, t] = st[0]
    return st, hs


class SLSTMScan(torch.autograd.Function):
    """``_slstm_loop`` with the JAX package's custom VJP
    (``_slstm_scan_cv``).  ``apply(r, b, gx, h, c, n, m)`` returns
    ``(h, c, n, m, hs)``.  The backward recomputes the per-step input
    states from the saved outputs, runs the steps in reverse (each step's
    cell differentiated alone), stacks each step's gate pre-activation
    gradient, and forms ``dr`` and ``db`` with one reduction over (B, S)
    after the loop."""

    @staticmethod
    def forward(ctx, r, b, gx, h, c, n, m):
        st, hs = _slstm_loop(r, b, gx, (h, c, n, m))
        ctx.save_for_backward(r, b, gx, h, c, n, m, hs)
        return (*st, hs)

    @staticmethod
    def backward(ctx, d_h, d_c, d_n, d_m, d_hs):
        r, b, gx, h0, c0, n0, m0, hs = ctx.saved_tensors
        B, S = gx.shape[:2]
        d = gx.shape[2] // 4
        dt = h0.dtype
        bb = b.reshape(4, d)
        h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)   # (B, S, d)

        def pre_of(t):
            rec = (h_prev[:, t] @ r).reshape(B, 4, d)
            return gx[:, t].to(dt).reshape(B, 4, d) + rec + bb

        # recompute the per-step input states
        states = [(h0, c0, n0, m0)]
        for t in range(S - 1):
            states.append(_slstm_cell(pre_of(t), states[-1]))
        d_st = (d_h, d_c, d_n, d_m)
        d_pre = [None] * S
        for t in reversed(range(S)):
            with torch.enable_grad():
                pre = pre_of(t).requires_grad_(True)
                # the cell reads h_{t-1} only through pre
                cnm = tuple(x.detach().requires_grad_(True)
                            for x in states[t][1:])
                out = _slstm_cell(pre, (states[t][0],) + cnm)
                grads = torch.autograd.grad(
                    out, (pre,) + cnm, (d_st[0] + d_hs[:, t],) + d_st[1:])
            d_pre[t] = grads[0].reshape(B, 4 * d)
            # the recurrent path to h_{t-1}, without a weight gradient
            d_st = (d_pre[t] @ r.T,) + grads[1:]
        d_pre = torch.stack(d_pre, dim=1)                      # (B, S, 4d)
        dr = torch.einsum("bsd,bse->de", h_prev, d_pre)
        db = torch.sum(d_pre, dim=(0, 1))
        return (dr, db, d_pre.to(gx.dtype)) + d_st


def _slstm_scan(p, gx, st):
    """gx: (B, S, 4d) input contributions; st: (h, c, n, m), each (B, d)
    float32.  Returns the last state and h (B, S, d) in float32."""
    *st, hs = SLSTMScan.apply(p["r"].float(), p["b"], gx, *st)
    return tuple(st), hs


def slstm_apply(p, x: torch.Tensor, cfg: XLSTMConfig, *,
                chunk: int = 256) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model).  As in the JAX package, gx
    is padded with zeros to a multiple of ``chunk`` steps and scanned
    chunk by chunk."""
    B, S, d = x.shape
    gx = _pad_time(x @ p["wx"], max(1, math.ceil(S / chunk)) * chunk, 0.0)
    z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    st = (z, z, z, z)
    r = p["r"].float()
    hs = []
    for c0 in range(0, gx.shape[1], chunk):
        *st, h = remat(SLSTMScan.apply, r, p["b"], gx[:, c0:c0 + chunk],
                       *st)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S].to(x.dtype) @ p["out"]


def slstm_decode_init(B, d_model, cfg: XLSTMConfig, device=None):
    z = torch.zeros((B, d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z, "m": z}


def slstm_decode_step(p, x: torch.Tensor, state, cfg: XLSTMConfig):
    """x: (B, 1, d_model); returns ``(out (B, 1, d_model), new_state)``."""
    st = (state["h"], state["c"], state["n"], state["m"])
    (h, c, n, m), hs = _slstm_scan(p, x @ p["wx"], st)
    return hs.to(x.dtype) @ p["out"], {"h": h, "c": c, "n": n, "m": m}
