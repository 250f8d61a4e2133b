from repro_torch.configs.arcane_paper import (
    FATTREE_32_CI, FATTREE_64_CI, FATTREE_128, FATTREE_1024,
)

__all__ = ["FATTREE_32_CI", "FATTREE_64_CI", "FATTREE_128", "FATTREE_1024"]
