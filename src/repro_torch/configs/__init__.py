from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, ModelConfig,
                                     ShapeConfig, reduced)
from repro_torch.configs.registry import (ASSIGNED, PAPER_MODELS, all_cells,
                                         get_config, get_smoke_config,
                                         shape_applicable)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SHAPE_BY_NAME", "reduced",
           "ASSIGNED", "PAPER_MODELS", "all_cells", "get_config",
           "get_smoke_config", "shape_applicable"]
