"""glm4-9b — assigned architecture config.

[dense] glm4-9b: 40L d=4096 32H kv=2 ff=13696 v=151552
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
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13_696,
    vocab=151_552,
    pattern=uniform_pattern("attn", 40),
    scan_period=1,
    sub_quadratic=False,
    rope_theta=10_000.0,
    source="[hf:THUDM/glm-4-9b; hf]",
)
