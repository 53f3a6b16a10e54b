"""llama4-scout-17b-a16e — assigned architecture config.

[moe] llama4-scout-17b-a16e: 48L d=5120 40H kv=8 ff=8192 v=202048 16e top-1
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
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202_048,
    # iRoPE-style 3 chunked-local : 1 global (public Llama-4 description)
    pattern=periodic_pattern(("attn_chunk", "attn_chunk", "attn_chunk", "attn"), 48),
    chunk=8192,
    moe=MoECfg(n_experts=16, top_k=1, d_ff_expert=8192),
    scan_period=4,
    train_microbatches=2,
    sub_quadratic=True,   # chunked attention is sub-quadratic
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
