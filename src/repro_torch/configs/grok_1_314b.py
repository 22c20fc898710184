"""grok-1-314b [moe]: 64L, d=6144, 48H (kv=8), ff=32768, vocab=131072,
MoE 8 experts top-2 every layer [hf:xai-org/grok-1; unverified].

MoE dispatch uses the GHOST sparse path (paper C1/C4 analogue).
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="grok_1_314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    pattern=(("attn", "moe"),),
    rope="rope",
    moe=MoEConfig(n_experts=8, top_k=2, ghost_dispatch=True),
    tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="grok_1_314b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=4, top_k=2, ghost_dispatch=True),
    tie_embeddings=False, dtype=torch.float32,
)

register("grok_1_314b", FULL, SMOKE,
         notes="GHOST sparse MoE dispatch; long_500k skipped")
