"""mistral-nemo-12b [dense]: 40L, d=5120, 32H (kv=8), ff=14336,
vocab=131072, head_dim=128, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="mistral_nemo_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    pattern=(("attn", "mlp"),),
    rope="rope", rope_theta=1_000_000.0,
    tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="mistral_nemo_12b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    pattern=(("attn", "mlp"),),
    tie_embeddings=False, dtype=torch.float32,
)

register("mistral_nemo_12b", FULL, SMOKE,
         notes="head_dim=128 (< d_model/n_heads); long_500k skipped")
