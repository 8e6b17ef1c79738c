from bevformer_torch.configs.config import (
    CONFIGS,
    BEVFormerConfig,
    DataConfig,
    OptimConfig,
    get_config,
)

__all__ = ["CONFIGS", "BEVFormerConfig", "DataConfig", "OptimConfig", "get_config"]
