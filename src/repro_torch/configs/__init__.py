from repro_torch.configs.base import (ALIASES, ARCH_IDS, PORTED_ARCHS,
                                      SHAPES, ArchConfig, ShapeSpec,
                                      cell_supported, get_config,
                                      get_smoke_config)

__all__ = ["ALIASES", "ARCH_IDS", "PORTED_ARCHS", "SHAPES", "ArchConfig",
           "ShapeSpec", "cell_supported", "get_config", "get_smoke_config"]
