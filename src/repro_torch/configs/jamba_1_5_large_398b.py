"""jamba-1.5-large-398b [hybrid]: 72L, d=8192, 64H (kv=8), ff=24576,
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every
other layer [arXiv:2403.19887; hf].

Period-8 block pattern (attention at index 4, Mamba elsewhere; MoE on odd
layers).  Sub-quadratic -> the long_500k cell runs for this arch.  FULL
and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

FULL = ModelConfig(
    name="jamba_1_5_large_398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    pattern=_PATTERN,
    rope="none",                      # jamba uses no positional encoding
    moe=MoEConfig(n_experts=16, top_k=2, ghost_dispatch=True),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="jamba_1_5_large_398b_smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    pattern=_PATTERN,
    rope="none",
    moe=MoEConfig(n_experts=4, top_k=2, ghost_dispatch=True),
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    tie_embeddings=False, dtype=torch.float32,
)

register("jamba_1_5_large_398b", FULL, SMOKE,
         notes="hybrid mamba/attn 7:1 + MoE 16e; long_500k RUNS")
