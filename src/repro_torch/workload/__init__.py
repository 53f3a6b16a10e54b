"""Adversarial edit-session workload generation + differential replay.

The standing stress suite for the whole verification stack:
``WorkloadConfig`` describes a traffic profile, ``SessionGenerator``
deterministically samples multi-version edit sessions over the W1-W8
shapes, and ``replay_sessions`` pushes them through a
``VerificationService`` while differential oracles cross-check every
answer against ground-truth execution and certificate replay.  See
docs/WORKLOADS.md.
"""

from repro_torch.workload.config import (
    DEFAULT_EDIT_MIX,
    EDIT_FAMILIES,
    WorkloadConfig,
    WorkloadConfigError,
    extended_config,
    smoke_config,
)
from repro_torch.workload.corpus import (
    DumpReport,
    WindowExample,
    dedupe_windows,
    dump_windows,
    example_key,
    load_windows,
    windows_from_certificate,
)
from repro_torch.workload.generator import (
    EXPECTED_ANY,
    EXPECTED_EQ,
    EditSession,
    PlannedPair,
    SessionGenerator,
)
from repro_torch.workload.replay import (
    OracleViolation,
    ReplayResult,
    canonical_sink_bytes,
    default_veer_config,
    replay_sessions,
)

__all__ = [
    "DEFAULT_EDIT_MIX",
    "EDIT_FAMILIES",
    "EXPECTED_ANY",
    "EXPECTED_EQ",
    "EditSession",
    "OracleViolation",
    "PlannedPair",
    "ReplayResult",
    "DumpReport",
    "SessionGenerator",
    "WindowExample",
    "WorkloadConfig",
    "WorkloadConfigError",
    "canonical_sink_bytes",
    "dedupe_windows",
    "default_veer_config",
    "dump_windows",
    "example_key",
    "extended_config",
    "load_windows",
    "replay_sessions",
    "smoke_config",
    "windows_from_certificate",
]
