from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchSpec,
    ShapeSpec,
    all_archs,
    get_arch,
    input_specs,
    register,
)
