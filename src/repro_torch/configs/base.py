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
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.transformer import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "ARCH_IDS", "ARCHS", "ArchEntry",
           "register", "list_archs", "get_config", "get_smoke_config",
           "shape_applicable", "dryrun_cells", "input_specs"]


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


def dryrun_cells() -> List[Tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells, in the registry's and
    ``SHAPES``' order."""
    cells = []
    for aid in list_archs():
        cfg = ARCHS[aid].config
        for sname, sp in SHAPES.items():
            ok, _ = shape_applicable(cfg, sp)
            if ok:
                cells.append((aid, sname))
    return cells


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                *, batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """The batch of one cell as tensors on ``meta`` (the JAX package's
    ``ShapeDtypeStruct``s).

    train/prefill: int32 tokens (B, S) [+ labels for train; a float32
    ``enc_embeds`` stub (B, S, d) for enc-dec, whose decoder then takes
    S // dec_len_ratio tokens].  decode: tokens (B, 1) [+ ``enc_embeds``];
    the cache is a separate argument (``init_cache``, see launch/dryrun.py).
    """
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32 = torch.int32

    if shape.kind in ("train", "prefill"):
        S_dec = S // cfg.dec_len_ratio if cfg.enc_dec else S
        spec = {"tokens": _spec((B, max(S_dec, 1)), i32)}
        if cfg.enc_dec:
            spec["enc_embeds"] = _spec((B, S, cfg.d_model), torch.float32)
        if shape.kind == "train":
            spec["labels"] = _spec(spec["tokens"].shape, i32)
        return spec

    # decode: one new token against a cache of S
    spec = {"tokens": _spec((B, 1), i32)}
    if cfg.enc_dec:
        spec["enc_embeds"] = _spec((B, S, cfg.d_model), torch.float32)
    return spec
