from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_cells,
    get_arch,
    list_archs,
    register,
)
