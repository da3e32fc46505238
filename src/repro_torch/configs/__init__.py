from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    MeshConfig,
    TrainConfig,
    SHAPES,
    applicable_shapes,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
