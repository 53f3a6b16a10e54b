"""internvl2-2b — assigned architecture config.

[vlm] internvl2-2b: 24L d=2048 16H kv=8 ff=8192 vocab=92553
"""

from repro_torch.configs.base import (
    ArchConfig,
    EncoderCfg,
    MoECfg,
    SSMCfg,
    VisionCfg,
    periodic_pattern,
    uniform_pattern,
)

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92_553,
    pattern=uniform_pattern("attn", 24),
    vision=VisionCfg(n_patches=1024, d_vision=1024),  # InternViT stub
    scan_period=1,
    train_microbatches=4,
    sub_quadratic=False,
    rope_theta=1_000_000.0,
    source="[arXiv:2404.16821; hf]",
)
