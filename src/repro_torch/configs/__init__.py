from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec  # noqa: F401
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config  # noqa: F401
