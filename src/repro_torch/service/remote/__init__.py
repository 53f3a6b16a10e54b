"""Shared remote tier for scale-out: the ``SharedTier`` protocol, its
local/file backends, and the cache adapters that graft a tier onto the
in-process ``VerdictCache``/``PairVerdictCache``/``MaterializationStore``
(see ``docs/SCALE_OUT.md``)."""

from repro_torch.service.remote.adapters import (
    TieredMaterializationStore,
    TieredPairCache,
    TieredVerdictCache,
)
from repro_torch.service.remote.filetier import FileLease, FileTier
from repro_torch.service.remote.tier import (
    Lease,
    LocalTier,
    PairRecord,
    SharedTier,
    make_tier,
)

__all__ = [
    "FileLease",
    "FileTier",
    "Lease",
    "LocalTier",
    "PairRecord",
    "SharedTier",
    "TieredMaterializationStore",
    "TieredPairCache",
    "TieredVerdictCache",
    "make_tier",
]
