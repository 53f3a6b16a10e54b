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
frontier that the reference also exports here comes with the port's reuse
layer.
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
    "ReplayFailure",
    "ReplayReport",
    "VeerConfig",
    "VerificationResult",
    "WindowRecord",
    "certificate_from_evidence",
    "default_registry",
    "pair_digest",
    "tampered",
    "verify",
]
