"""gemma3-27b — assigned architecture config.

[dense] gemma3-27b: 62L d=5376 32H kv=16 ff=21504 v=262144, 5:1 local:global
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
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21_504,
    vocab=262_144,
    pattern=periodic_pattern(
        ("attn_local",) * 5 + ("attn",), 62
    ),
    window=1024,
    scan_period=6,
    train_microbatches=2,
    sub_quadratic=True,    # 5:1 sliding-window
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
