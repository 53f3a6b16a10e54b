"""whisper-tiny — assigned architecture config.

[audio] whisper-tiny: 4L enc-dec d_model=384 6H d_ff=1536 vocab=51865
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
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab=51_865,
    pattern=uniform_pattern("attn", 4),
    encoder=EncoderCfg(n_layers=4, n_frames=1500, d_frame=384),
    scan_period=1,
    train_microbatches=2,
    sub_quadratic=False,
    rope_theta=10_000.0,
    source="[arXiv:2212.04356; unverified]",
)
