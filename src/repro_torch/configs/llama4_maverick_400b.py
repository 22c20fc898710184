"""llama4-maverick-400b-a17b [moe]: 48L, d=5120, 40H (kv=8), ff=8192,
vocab=202048, MoE 128 experts top-1, alternating dense/MoE layers (the
maverick interleave), early-fusion multimodal (frontend stubbed)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="llama4_maverick_400b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    pattern=(("attn", "mlp"), ("attn", "moe")),     # dense/MoE interleave
    rope="rope", rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, ghost_dispatch=True),
    tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="llama4_maverick_400b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    pattern=(("attn", "mlp"), ("attn", "moe")),
    moe=MoEConfig(n_experts=4, top_k=1, ghost_dispatch=True),
    tie_embeddings=False, dtype=torch.float32,
)

register("llama4_maverick_400b", FULL, SMOKE,
         notes="128e top-1; long_500k skipped")
