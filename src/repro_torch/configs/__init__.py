from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import get_config, get_smoke_config

__all__ = ["ModelConfig", "reduced", "get_config", "get_smoke_config"]
