"""Analytic per-device cost model (FLOPs / memory bytes / collective
bytes), and the SpMV roofline terms (GHOST sections 2 and 4.1).

The port of ``repro/launch/costmodel.py``; each formula keeps the JAX
package's arithmetic order, so the results are equal.

The language models' half (``analytic_cost``) is the structural model
the dry run's roofline terms come from: XLA's ``cost_analysis`` counts a
``while`` body once, which is why the JAX package has it, and the port
has no compiled analysis at all.  Conventions:
  * per-device quantities; compute assumed evenly sharded over the mesh.
  * bf16 params/activations (2 B), f32 optimizer state (4 B).
  * attention is counted at the computed cost of a streamed kernel: full
    masked tiles unless ``causal_skip`` (the port's attention always
    skips the tiles the causal mask empties, so its dry run passes
    ``causal_skip=True``).
  * a Mamba scan through the kernel B6 (``scan_impl="kernel"``, the JAX
    package's ``"pallas"``) streams only its (B, S, d_inner) inputs.

The SpMV terms feed :class:`repro_torch.runtime.devicepool.DevicePool`:
the heterogeneous engine weights each device class by its *attainable
SpMV throughput*, which for a bandwidth-bound kernel is  bw /
code_balance.  The paper's reference point: double precision values +
32-bit indices give the minimum code balance of (8 + 4) / 2 = 6
bytes/flop, hence the predicted aggregate 350/6 = 58 Gflop/s for the full
CPU+GPU+PHI node (Table 1).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict

if TYPE_CHECKING:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.transformer import ModelConfig

__all__ = ["Cost", "spmv_code_balance", "spmv_cost", "analytic_cost",
           "T_enc_dec_kv", "BF16", "F32"]

BF16 = 2
F32 = 4


@dataclasses.dataclass
class Cost:
    flops: float = 0.0            # per device
    hbm_bytes: float = 0.0        # per device
    coll_bytes: float = 0.0       # per device (interconnect bytes)
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, key, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll
        self.detail[key] = self.detail.get(key, 0.0) + flops


def spmv_code_balance(*, val_bytes: int = 8, idx_bytes: int = 4,
                      nvecs: int = 1, nnzr: float = float("inf"),
                      rhs_reload: float = 0.0) -> float:
    """Bytes of memory traffic per flop of a SELL-C-sigma SpM(M)V.

    Per nonzero and right-hand-side column: matrix value + column index are
    streamed once (amortized over ``nvecs`` block-vector columns), the
    output row is written (and read for beta-accumulation) once per row —
    i.e. ``2 * val_bytes / nnzr`` per nonzero — and ``rhs_reload`` accounts
    for x-gather traffic beyond the first load (0 = perfect cache
    residency, 1 = every gather misses).  Flops per nonzero per column: 2.
    """
    mat = (val_bytes + idx_bytes) / nvecs
    vec = 2.0 * val_bytes / max(nnzr, 1.0) + rhs_reload * val_bytes
    return (mat + vec) / 2.0


def spmv_cost(nnz: int, nrows: int, *, val_bytes: int = 8,
              idx_bytes: int = 4, nvecs: int = 1,
              rhs_reload: float = 0.0) -> Cost:
    """Structural roofline inputs for one SpM(M)V over ``nnz`` nonzeros."""
    c = Cost()
    nnzr = nnz / max(nrows, 1)
    cb = spmv_code_balance(val_bytes=val_bytes, idx_bytes=idx_bytes,
                           nvecs=nvecs, nnzr=nnzr, rhs_reload=rhs_reload)
    flops = 2.0 * nnz * nvecs
    c.add("spmv", flops=flops, hbm=flops * cb)
    return c


def _layer_param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Matmul parameters per *instance* of each sub-layer kind."""
    d, hd = cfg.d_model, cfg.hd
    H, KV, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    out = {}
    out["attn"] = d * (H * hd) * 2 + d * (KV * hd) * 2        # q,o + k,v
    out["xattn"] = out["attn"]
    out["mlp"] = d * ff * (3 if cfg.act == "swiglu" else 2)
    if cfg.moe is not None:
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        per_exp = d * ff * (3 if cfg.act == "swiglu" else 2)
        out["moe_active"] = per_exp * K                        # per token
        out["moe_total"] = per_exp * E
        out["router"] = d * E
    di = cfg.ssm.inner(d)
    out["mamba"] = (d * 2 * di + di * (cfg.ssm.rank(d) + 2 * cfg.ssm.d_state)
                    + cfg.ssm.rank(d) * di + di * d)
    dix = cfg.xlstm.expand * d
    out["mlstm"] = d * 2 * dix + 3 * dix * dix + dix * d
    out["slstm"] = d * 4 * d + 4 * (d // cfg.xlstm.n_heads) * d + d * d
    return out


def _pattern_counts(cfg: ModelConfig, layers: int) -> Dict[str, int]:
    """How many instances of each sub-layer kind in `layers` layers."""
    counts: Dict[str, int] = {}
    full = (list(cfg.pattern) * ((layers + cfg.period - 1) // cfg.period))[:layers]
    for mix, ffn in full:
        counts[mix] = counts.get(mix, 0) + 1
        if ffn != "none":
            counts[ffn] = counts.get(ffn, 0) + 1
    return counts


def analytic_cost(cfg: ModelConfig, shape: ShapeSpec, n_dev: int,
                  *, dp: int, tp: int, causal_skip: bool = False,
                  zero1: bool = False,
                  train_flop_mult: float = 3.0) -> Cost:
    """Per-device roofline inputs for one (arch x shape) cell."""
    c = Cost()
    S = shape.seq_len
    B = shape.global_batch
    kind = shape.kind
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    V = cfg.padded_vocab
    pc = _layer_param_counts(cfg)

    # tokens processed globally this step
    if kind == "decode":
        T = B                                  # one token per sequence
        S_dec = 1
    elif cfg.enc_dec:
        S_dec = S // cfg.dec_len_ratio
        T = B * S_dec
        T_enc = B * S
    else:
        S_dec = S
        T = B * S

    mult = train_flop_mult if kind == "train" else 1.0
    attn_mult = 0.5 if causal_skip else 1.0

    def stack_cost(layers: int, T_stack: float, S_ctx: float, causal: bool):
        """Matmul + mixer flops for a stack over T_stack tokens with
        context length S_ctx."""
        n = _pattern_counts(cfg, layers)
        f = 0.0
        # projections / FFN / MoE: 2 flops per param per token
        f += n.get("attn", 0) * 2 * T_stack * pc["attn"]
        f += n.get("mlp", 0) * 2 * T_stack * pc["mlp"]
        if cfg.moe is not None and n.get("moe"):
            f += n["moe"] * 2 * T_stack * (pc["moe_active"] + pc["router"])
        f += n.get("mamba", 0) * (2 * T_stack * pc["mamba"]
                                  + T_stack * cfg.ssm.inner(d)
                                  * cfg.ssm.d_state * 6)
        f += n.get("mlstm", 0) * (2 * T_stack * pc["mlstm"]
                                  + T_stack * cfg.xlstm.n_heads
                                  * (cfg.xlstm.expand * d // cfg.xlstm.n_heads) ** 2 * 4)
        f += n.get("slstm", 0) * (2 * T_stack * pc["slstm"])
        # attention score+value flops: 4 * T * S_ctx * H * hd
        am = attn_mult if causal else 1.0
        f += n.get("attn", 0) * 4 * T_stack * S_ctx * H * hd * am
        return f

    # ---- compute -----------------------------------------------------
    if cfg.enc_dec and kind != "decode":
        c.add("encoder", flops=mult * stack_cost(cfg.n_enc_layers, T_enc, S,
                                                 causal=False) / n_dev)
        f_dec = stack_cost(cfg.n_layers, T, S_dec, causal=True)
        f_dec += cfg.n_layers * (2 * T * pc["xattn"] / 2                 # kv proj on enc side
                                 + 2 * T_enc * pc["xattn"] / 2
                                 + 4 * T * S * H * hd)                   # cross attn
        c.add("decoder", flops=mult * f_dec / n_dev)
    elif cfg.enc_dec and kind == "decode":
        f_dec = stack_cost(cfg.n_layers, T, S, causal=True)              # self on cache S
        f_dec += cfg.n_layers * (2 * T_enc_dec_kv(cfg, B, S)             # enc kv proj
                                 + 4 * T * S * H * hd)                   # cross attn
        c.add("decoder", flops=mult * f_dec / n_dev)
    else:
        S_ctx = S if kind != "decode" else S                             # decode: cache len S
        c.add("decoder", flops=mult * stack_cost(cfg.n_layers, T, S_ctx,
                                                 causal=True) / n_dev)
    # lm head + embed
    c.add("head", flops=mult * 2 * T * d * V / n_dev)

    # ---- HBM bytes -----------------------------------------------------
    n_params = _total_params(cfg)
    # per-device weight bytes touched per step: the FSDP all-gather leaves a
    # full copy along 'data' but still sharded 1/tp along 'model'
    p_gathered = n_params * BF16 / tp
    if kind == "train":
        big = n_params > 50e9
        # optimizer touches the 1/n_dev shard: adam ~6 f32 arrays r+w,
        # adafactor ~3
        opt_bytes = (3 if big else 6) * n_params * F32 / n_dev
        if zero1:
            # params resident (replicated): read fwd + bwd, grads written
            weight_traffic = 3 * n_params * BF16
        else:
            weight_traffic = 3 * p_gathered              # fwd + remat + bwd
        act = _act_bytes(cfg, T, dp, tp, train=True)
        rec = _recurrent_state_bytes(cfg, B / dp, S_dec, train=True)
        c.hbm_bytes = weight_traffic + opt_bytes + act + rec
    elif kind == "prefill":
        weight_traffic = p_gathered
        act = _act_bytes(cfg, T, dp, tp, train=False)
        rec = _recurrent_state_bytes(cfg, B / dp, S_dec, train=False)
        c.hbm_bytes = weight_traffic + act + rec
    else:  # decode
        weight_traffic = p_gathered                   # every param read once
        cache = _cache_bytes(cfg, B, S) / n_dev       # cache read once
        c.hbm_bytes = weight_traffic + cache

    # ---- collective bytes ----------------------------------------------
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    T_loc = (T if kind == "decode" else T) / dp
    if kind == "train":
        # FSDP: all-gather params fwd + bwd, reduce-scatter grads (bf16)
        fsdp = 3 * (n_params * BF16 / tp) * (dp - 1) / dp
        # TP: 2 all-reduces per layer fwd, 2 bwd, on (T_loc, d) bf16
        tpc = 4 * L * T_loc * d * BF16 * 2 * (tp - 1) / tp if tp > 1 else 0
        c.coll_bytes = fsdp + tpc
    elif kind == "prefill":
        fsdp = (n_params * BF16 / tp) * (dp - 1) / dp
        tpc = 2 * L * T_loc * d * BF16 * 2 * (tp - 1) / tp if tp > 1 else 0
        c.coll_bytes = fsdp + tpc
    else:
        fsdp = (n_params * BF16 / tp) * (dp - 1) / dp
        tpc = 2 * L * T_loc * d * BF16 * 2 * (tp - 1) / tp if tp > 1 else 0
        c.coll_bytes = fsdp + tpc
    return c


def T_enc_dec_kv(cfg, B, S):
    return B * S * cfg.d_model * cfg.n_kv_heads * cfg.hd // cfg.d_model


def _total_params(cfg: ModelConfig) -> float:
    pc = _layer_param_counts(cfg)
    n = _pattern_counts(cfg, cfg.n_layers)
    total = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    total += n.get("attn", 0) * pc["attn"]
    total += n.get("mlp", 0) * pc["mlp"]
    if cfg.moe is not None and n.get("moe"):
        total += n["moe"] * (pc["moe_total"] + pc["router"])
    total += n.get("mamba", 0) * pc["mamba"]
    total += n.get("mlstm", 0) * pc["mlstm"]
    total += n.get("slstm", 0) * pc["slstm"]
    if cfg.enc_dec:
        ne = _pattern_counts(cfg, cfg.n_enc_layers)
        total += ne.get("attn", 0) * pc["attn"] * 2      # + cross attn
        total += ne.get("mlp", 0) * pc["mlp"]
    return total


def _recurrent_state_bytes(cfg: ModelConfig, B_loc: float, S: int,
                           *, train: bool) -> float:
    """Memory traffic of recurrent state streaming (the term that dominates
    SSM/xLSTM training and that the chunkwise and fused forms attack).

    recurrent mLSTM: the (H, dh, dh) f32 matrix memory is read+written
    every timestep; chunkwise: once per chunk + intra-chunk (W x W) tiles.
    mamba (materialized): dA/dBx (B, S, di, N) f32 are written + read
    (+ re-read in backward); kernel: recomputed in registers from (B, S, di).
    """
    n = _pattern_counts(cfg, cfg.n_layers)
    mult = 3.0 if train else 1.0          # fwd + bwd re-traffic
    total = 0.0
    if n.get("mlstm"):
        H = cfg.xlstm.n_heads
        dh = cfg.xlstm.expand * cfg.d_model // H
        state = B_loc * H * dh * dh * F32
        if cfg.xlstm.chunkwise:
            W = cfg.xlstm.chunk
            steps = (S + W - 1) // W
            intra = B_loc * S * W * H * F32 * 2          # D/score tiles
            total += n["mlstm"] * (2 * state * steps + intra) * mult
        else:
            total += n["mlstm"] * 2 * state * S * mult
    if n.get("slstm"):
        total += n["slstm"] * 2 * (B_loc * 4 * cfg.d_model * F32) * S * mult
    if n.get("mamba"):
        di = cfg.ssm.inner(cfg.d_model)
        N = cfg.ssm.d_state
        impl = getattr(cfg.ssm, "scan_impl", "materialized")
        if impl == "kernel":
            # state held on chip (B6); only the (B, S, di) inputs stream
            total += n["mamba"] * 4 * (B_loc * S * di * F32) * mult
        elif impl == "chunked":
            # dA/dBx recomputed per step; state (B, di, N) r/w per step
            total += n["mamba"] * 2 * (B_loc * di * N * F32) * S * mult
        else:
            # materialized dA/dBx (B, S, di, N): write + read (+bwd)
            total += n["mamba"] * 2 * (B_loc * S * di * N * F32) * 2 * mult
    return total


def _act_bytes(cfg: ModelConfig, T: float, dp: int, tp: int,
               *, train: bool) -> float:
    """Activation traffic per device.

    Residual-stream tensors (norms, adds, projections in d_model) are
    sharded on dp only (~6 sweeps/layer); wide internals (d_ff / head
    tensors) are additionally tp-sharded (~8 sweeps/layer of the widest
    dim).  Remat'ed backward re-reads ~2.5x."""
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    wide = max(cfg.d_ff, cfg.n_heads * cfg.hd,
               cfg.ssm.inner(cfg.d_model) if any(
                   m == "mamba" for m, _ in cfg.pattern) else 0,
               cfg.xlstm.expand * cfg.d_model if any(
                   m in ("mlstm", "slstm") for m, _ in cfg.pattern) else 0)
    mult = 2.5 if train else 1.0
    resid = 6 * T * cfg.d_model / dp
    inner = 8 * T * wide / (dp * tp)
    return L * (resid + inner) * BF16 * mult


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    n_attn = _pattern_counts(cfg, cfg.n_layers).get("attn", 0)
    kv = 2 * n_attn * B * S * cfg.n_kv_heads * cfg.hd * BF16
    # recurrent states are O(1) in S
    n = _pattern_counts(cfg, cfg.n_layers)
    di = cfg.ssm.inner(cfg.d_model)
    kv += n.get("mamba", 0) * B * di * cfg.ssm.d_state * F32
    dh = cfg.xlstm.expand * cfg.d_model // cfg.xlstm.n_heads
    kv += n.get("mlstm", 0) * B * cfg.xlstm.n_heads * dh * dh * F32
    return kv
