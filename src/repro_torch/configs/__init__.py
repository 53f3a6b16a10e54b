from repro_torch.configs.base import (
    ArchConfig,
    EncoderCfg,
    MoECfg,
    SSMCfg,
    ShapeConfig,
    SHAPES,
    VisionCfg,
    shape_applicable,
)

__all__ = [
    "ArchConfig", "EncoderCfg", "MoECfg", "SSMCfg", "ShapeConfig",
    "SHAPES", "VisionCfg", "shape_applicable", "ARCHS", "get_arch",
]


def __getattr__(name):
    # late import to avoid a configs.registry <-> configs.<arch> cycle
    if name in ("ARCHS", "get_arch"):
        from repro_torch.configs import registry

        return getattr(registry, name)
    raise AttributeError(name)
