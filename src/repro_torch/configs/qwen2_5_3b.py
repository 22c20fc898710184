"""qwen2.5-3b [dense]: 36L, d=2048, 16H (kv=2), ff=11008, vocab=151936 —
GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen2_5_3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    pattern=(("attn", "mlp"),),
    rope="rope", rope_theta=1_000_000.0, qkv_bias=True,
    tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="qwen2_5_3b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    pattern=(("attn", "mlp"),), qkv_bias=True,
    dtype=torch.float32,
)

register("qwen2_5_3b", FULL, SMOKE,
         notes="QKV bias; long_500k skipped (full attention)")
