"""xlstm-1.3b [ssm]: 48L, d=2048, 4H (kv=4), d_ff=0, vocab=50304 —
sLSTM + mLSTM blocks, 7:1 interleave [arXiv:2405.04517; unverified].

d_ff=0: the mLSTM/sLSTM blocks carry their own up/down projections, no
separate MLP.  Sub-quadratic -> long_500k RUNS.
FULL and SMOKE are the JAX package's, field for field."""
import torch

from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig
from repro_torch.models.xlstm import XLSTMConfig

_PATTERN = tuple(
    ("slstm" if i == 7 else "mlstm", "none") for i in range(8)
)

FULL = ModelConfig(
    name="xlstm_1_3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    pattern=_PATTERN,
    rope="none",
    xlstm=XLSTMConfig(n_heads=4, expand=2, slstm_every=8),
    tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="xlstm_1_3b_smoke", family="ssm",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512,
    pattern=_PATTERN,
    rope="none",
    xlstm=XLSTMConfig(n_heads=4, expand=2, slstm_every=8),
    dtype=torch.float32,
)

register("xlstm_1_3b", FULL, SMOKE,
         notes="mLSTM/sLSTM 7:1, recurrent decode state; long_500k RUNS")
