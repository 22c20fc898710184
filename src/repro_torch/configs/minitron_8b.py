"""minitron-8b [dense]: 32L, d=4096, 32H (kv=8), ff=16384, vocab=256000 —
pruned nemotron [arXiv:2407.14679; hf].
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="minitron_8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    pattern=(("attn", "mlp"),),
    rope="rope", rope_theta=10000.0,
    tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="minitron_8b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    pattern=(("attn", "mlp"),),
    tie_embeddings=False, dtype=torch.float32,
)

register("minitron_8b", FULL, SMOKE,
         notes="dense GQA; long_500k skipped (full attention)")
