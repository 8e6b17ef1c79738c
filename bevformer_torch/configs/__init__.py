from bevformer_torch.configs.config import (
    CONFIGS,
    BEVFormerConfig,
    DataConfig,
    get_config,
)

__all__ = ["CONFIGS", "BEVFormerConfig", "DataConfig", "get_config"]
