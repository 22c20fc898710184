"""whisper-medium [audio]: enc-dec, 24+24L, d=1024, 16H (kv=16), ff=4096,
vocab=51865 [arXiv:2212.04356; unverified].  Conv frontend is a STUB:
callers pass precomputed frame embeddings (B, S, d) as ``enc_embeds``.
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="whisper_medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    pattern=(("attn", "mlp"),),
    rope="sinusoidal", norm="layernorm", act="gelu",
    tie_embeddings=True, enc_dec=True, n_enc_layers=24, dec_len_ratio=8,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="whisper_medium_smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    pattern=(("attn", "mlp"),),
    rope="sinusoidal", norm="layernorm", act="gelu",
    tie_embeddings=True, enc_dec=True, n_enc_layers=2, dec_len_ratio=4,
    dtype=torch.float32,
)

register("whisper_medium", FULL, SMOKE,
         notes="enc-dec; frontend stubbed; full attention -> long_500k skipped")
