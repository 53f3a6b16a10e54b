"""The unified public verification API.

One import surface for everything a verification caller needs:

  * ``EVRegistry`` / ``default_registry`` — named EV plugins with
    capability metadata (fragment, monotonicity, inequivalence power);
  * ``VeerConfig`` — validated, serializable verifier description with
    ``build() -> Veer``;
  * ``verify`` — the facade: verdict + stats + replayable certificate;
  * ``Certificate`` / ``ReplayReport`` — machine-checkable evidence behind
    every True/False verdict (``replay`` re-checks with fresh EVs, JSON
    round-trips for cross-session audit).

It is the port's copy of the reference package's ``api``: certificates and
configs written by one package read, and replay, in the other.  The reuse
frontier (``compute_reuse_frontier``: which operators of a certified pair's
successor may be served from its predecessor's results) is exported here
too.  The chain service (``repro_torch.service``) and reuse manager
(``repro_torch.reuse``) are built on this surface.
"""

from repro_torch.api.certificate import (
    Certificate,
    CertificateFormatError,
    ReplayFailure,
    ReplayReport,
    WindowRecord,
    certificate_from_evidence,
    pair_digest,
    tampered,
)
from repro_torch.api.config import ConfigError, VeerConfig
from repro_torch.api.facade import VerificationResult, verify
from repro_torch.core.frontier import (
    FrontierEntry,
    FrontierError,
    ReuseFrontier,
    compute_reuse_frontier,
)
from repro_torch.api.registry import (
    DEFAULT_EV_NAMES,
    EVRegistry,
    EVSpec,
    default_registry,
)

__all__ = [
    "Certificate",
    "CertificateFormatError",
    "ConfigError",
    "DEFAULT_EV_NAMES",
    "EVRegistry",
    "EVSpec",
    "FrontierEntry",
    "FrontierError",
    "ReplayFailure",
    "ReuseFrontier",
    "ReplayReport",
    "VeerConfig",
    "VerificationResult",
    "WindowRecord",
    "certificate_from_evidence",
    "compute_reuse_frontier",
    "default_registry",
    "pair_digest",
    "tampered",
    "verify",
]
