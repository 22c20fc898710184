"""qwen2-vl-7b [vlm]: 28L, d=3584, 28H (kv=4), ff=18944, vocab=152064 —
M-RoPE, dynamic resolution [arXiv:2409.12191; hf].  Backbone only; the
vision patch-embedding frontend is a STUB per the assignment spec
(positions3 default to text positions).
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen2_vl_7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    pattern=(("attn", "mlp"),),
    rope="mrope", rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    qkv_bias=True, tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="qwen2_vl_7b_smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    pattern=(("attn", "mlp"),),
    rope="mrope", mrope_sections=(2, 3, 3), qkv_bias=True,
    tie_embeddings=False, dtype=torch.float32,
)

register("qwen2_vl_7b", FULL, SMOKE,
         notes="M-RoPE; vision frontend stubbed; long_500k skipped")
