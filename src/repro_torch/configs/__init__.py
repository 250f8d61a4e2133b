from repro_torch.configs.arcane_paper import (
    FATTREE_32_CI, FATTREE_64_CI, FATTREE_128, FATTREE_128_3T, FATTREE_128_OVERSUB4,
    FATTREE_1024,
)
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    applicable_shapes,
    get_config,
    reduced,
    register,
)

__all__ = ["FATTREE_32_CI", "FATTREE_64_CI", "FATTREE_128", "FATTREE_128_3T",
           "FATTREE_128_OVERSUB4", "FATTREE_1024",
           "SHAPES", "ModelConfig", "ShapeConfig", "all_configs",
           "applicable_shapes", "get_config", "reduced", "register"]
