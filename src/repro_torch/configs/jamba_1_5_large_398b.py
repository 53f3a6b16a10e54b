"""jamba-1.5-large-398b — assigned architecture config.

[hybrid] 72L d=8192 64H kv=8 ff=24576 v=65536 — Mamba+attn 1:7 interleave,
MoE 16e top-2 (every other layer). [arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import (
    ArchConfig,
    MoECfg,
    SSMCfg,
    periodic_pattern,
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24_576,
    vocab=65_536,
    pattern=periodic_pattern(
        ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
        72,
    ),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24_576, every=2, offset=1),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, n_groups=1),
    scan_period=8,
    head_sharded_attn=False,  # §Perf it.7: propagation beats forced specs here
    train_microbatches=1,  # §Perf: mb>1 multiplies per-µbatch weight collectives — refuted
    sub_quadratic=True,
    source="[arXiv:2403.19887; hf]",
)
