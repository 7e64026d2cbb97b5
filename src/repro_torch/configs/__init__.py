from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ArchConfig", "ARCH_IDS", "get_config", "get_smoke_config"]
