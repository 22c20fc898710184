"""llama3.2-3b [dense]: 28L, d=3072, 24H (kv=8), ff=8192, vocab=128256 —
small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="llama3_2_3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    pattern=(("attn", "mlp"),),
    rope="rope", rope_theta=500_000.0,
    tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="llama3_2_3b_smoke", family="dense",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
    d_ff=96, vocab_size=512,
    pattern=(("attn", "mlp"),),
    dtype=torch.float32,
)

register("llama3_2_3b", FULL, SMOKE,
         notes="24 heads; long_500k skipped")
