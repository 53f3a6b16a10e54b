"""Service layer: chain-level verification with cross-pair verdict reuse.

``VersionChainSession`` serves one client's version chain, verifying each
pair and, given sources, executing each version with certificate-backed
reuse or delta-cone execution on the torch data plane;
``PairVerdictCache`` shares whole-pair verdicts between sessions;
``VerificationService`` multiplexes many concurrent sessions over threads
and one shared, thread-safe verdict cache (``repro_torch.service.server``);
``VerificationFleet`` shards clients across worker *processes* over a
shared cache tier (``repro_torch.service.fleet`` /
``repro_torch.service.remote``).  The service and the fleet take
``device=`` (default ``"cuda"``) for every session's execution.
"""

from repro_torch.service.chain import (
    ChainReport,
    PairReport,
    VersionChainSession,
    verify_chain,
)
from repro_torch.service.fleet import (
    ConsistentHashRing,
    FleetRegistryError,
    FleetReport,
    FleetWorkerLost,
    VerificationFleet,
    shard_key,
    stop_helper_processes,
)
from repro_torch.service.pair_cache import PairEntry, PairVerdictCache
from repro_torch.service.server import (
    ServiceBusy,
    ServiceClosed,
    ServiceReport,
    VerificationService,
)
from repro_torch.core.ev.cache import VerdictCache

__all__ = [
    "ChainReport",
    "ConsistentHashRing",
    "FleetRegistryError",
    "FleetReport",
    "FleetWorkerLost",
    "PairEntry",
    "PairReport",
    "PairVerdictCache",
    "ServiceBusy",
    "ServiceClosed",
    "ServiceReport",
    "VerificationFleet",
    "VerificationService",
    "VersionChainSession",
    "verify_chain",
    "VerdictCache",
    "shard_key",
    "stop_helper_processes",
]
