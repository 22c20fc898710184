"""Config registry: the ported architectures x input shapes.

The port of ``repro/configs/base.py``.  Every architecture registers its
full :class:`ModelConfig` (the published widths) plus a reduced smoke
variant (same family and pattern, tiny widths) for CPU tests.  The ten
architectures are the JAX package's, in its order.

Shape cells (LM shapes are seq_len x global_batch):
    train_4k     4,096 x 256   train_step
    prefill_32k  32,768 x 32   serve prefill (forward, no loss)
    decode_32k   32,768 x 128  serve_step: 1 new token, KV cache of seq_len
    long_500k    524,288 x 1   serve_step; sub-quadratic archs only
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.transformer import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "ARCH_IDS", "ARCHS", "ArchEntry",
           "register", "list_archs", "get_config", "get_smoke_config",
           "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "whisper_medium", "minitron_8b", "qwen2_5_3b", "mistral_nemo_12b",
    "llama3_2_3b", "qwen2_vl_7b", "grok_1_314b", "llama4_maverick_400b",
    "jamba_1_5_large_398b", "xlstm_1_3b",
]

ARCHS: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    smoke: ModelConfig
    notes: str = ""


def register(arch_id: str, config: ModelConfig, smoke: ModelConfig,
             notes: str = ""):
    ARCHS[arch_id] = ArchEntry(config, smoke, notes)


def _load_all():
    for aid in ARCH_IDS:
        if aid not in ARCHS:
            importlib.import_module(f"repro_torch.configs.{aid}")


def list_archs() -> List[str]:
    _load_all()
    return list(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    _load_all()
    return ARCHS[arch_id].config


def get_smoke_config(arch_id: str) -> ModelConfig:
    _load_all()
    return ARCHS[arch_id].smoke


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The long_500k sub-quadratic rule."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k skipped (quadratic)"
    return True, ""
