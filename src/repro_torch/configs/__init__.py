"""Config registry of the port: the JAX package's ten architectures, the
input shapes and the dry run's cells."""
from repro_torch.configs.base import (SHAPES, ShapeSpec, dryrun_cells,
                                      get_config, get_smoke_config,
                                      input_specs, list_archs, register,
                                      shape_applicable)

__all__ = ["SHAPES", "ShapeSpec", "get_config", "get_smoke_config",
           "list_archs", "register", "shape_applicable", "dryrun_cells",
           "input_specs"]
