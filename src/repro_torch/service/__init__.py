"""Service layer: chain-level verification with cross-pair verdict reuse.

``VersionChainSession`` serves one client's version chain, verifying each
pair and, given sources, executing each version with certificate-backed
reuse or delta-cone execution on the torch data plane;
``PairVerdictCache`` shares whole-pair verdicts between sessions.  The
reference package's ``VerificationService`` (threads over one shared cache)
and ``VerificationFleet`` (worker processes over a shared cache tier) are
not part of the port yet.
"""

from repro_torch.service.chain import (
    ChainReport,
    PairReport,
    VersionChainSession,
    verify_chain,
)
from repro_torch.service.pair_cache import PairEntry, PairVerdictCache
from repro_torch.core.ev.cache import VerdictCache

__all__ = [
    "ChainReport",
    "PairEntry",
    "PairReport",
    "PairVerdictCache",
    "VersionChainSession",
    "verify_chain",
    "VerdictCache",
]
