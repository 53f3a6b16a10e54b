"""mamba2-2.7b — assigned architecture config.

[ssm] mamba2-2.7b: 64L d_model=2560, attn-free, vocab 50280, state 128
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
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,            # d_inner / head_dim = 2*2560/64
    n_kv_heads=80,
    d_head=64,
    d_ff=0,                # attn-free, no FFN in mamba2 blocks
    vocab=50_280,
    pattern=uniform_pattern("mamba", 64),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, n_groups=1),
    scan_period=1,
    train_microbatches=2,
    sub_quadratic=True,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
