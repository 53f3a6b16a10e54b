"""llama4-maverick-400b-a17b — assigned architecture config.

[moe] llama4-maverick-400b-a17b: same but 128e top-1
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
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202_048,
    pattern=periodic_pattern(("attn_chunk", "attn_chunk", "attn_chunk", "attn"), 48),
    chunk=8192,
    # MoE every other layer (dense FFN between) — matches the ~400B total
    moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, every=2, offset=1),
    scan_period=4,
    train_microbatches=4,
    sub_quadratic=True,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
