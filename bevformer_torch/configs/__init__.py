from bevformer_torch.configs.config import (
    CONFIGS,
    BEVFormerConfig,
    DataConfig,
    OptimConfig,
    apply_overrides,
    get_config,
)

__all__ = ["CONFIGS", "BEVFormerConfig", "DataConfig", "OptimConfig", "apply_overrides",
           "get_config"]
