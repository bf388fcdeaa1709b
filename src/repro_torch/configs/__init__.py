from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    SMOKES,
    get_arch,
    get_smoke,
    list_archs,
)
