"""llama3-8b — assigned architecture config.

[dense] llama3-8b: 32L d=4096 32H kv=8 ff=14336 v=128256
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
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab=128_256,
    pattern=uniform_pattern("attn", 32),
    scan_period=1,
    sub_quadratic=False,
    rope_theta=500_000.0,
    source="[arXiv:2407.21783; unverified]",
)
