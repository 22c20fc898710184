"""Config registry of the port: the JAX package's ten architectures."""
from repro_torch.configs.base import (SHAPES, ShapeSpec, get_config,
                                      get_smoke_config, list_archs, register,
                                      shape_applicable)

__all__ = ["SHAPES", "ShapeSpec", "get_config", "get_smoke_config",
           "list_archs", "register", "shape_applicable"]
