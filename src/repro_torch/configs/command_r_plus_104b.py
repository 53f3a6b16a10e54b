"""command-r-plus-104b — assigned architecture config.

[dense] command-r-plus-104b: 64L d=12288 96H kv=8 ff=33792 v=256000
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
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33_792,
    vocab=256_000,
    pattern=uniform_pattern("attn", 64),
    scan_period=1,
    train_microbatches=4,
    sub_quadratic=False,
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
)
