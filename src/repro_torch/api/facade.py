"""``repro_torch.api.verify`` — the one public entry point for pair verification.

    from repro_torch.api import VeerConfig, verify

    result = verify(P, Q, config=VeerConfig(evs=("equitas", "spes", "udp")))
    if result.equivalent:
        assert result.certificate.replay().ok   # audit, don't trust

Every True/False verdict carries a replayable ``Certificate``; Unknown
carries none (there is nothing to certify).  The heavy objects (``Veer``,
EV instances, verdict cache) are wired from the config through the registry
— callers never touch ``make_veer_plus(**kw)`` keyword soup again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.api.certificate import Certificate, certificate_from_evidence
from repro_torch.api.config import VeerConfig
from repro_torch.api.registry import EVRegistry, default_registry
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.verifier import Veer, VeerStats


@dataclass(frozen=True)
class VerificationResult:
    """Verdict + search stats + (for decided verdicts) the certificate.

    ``reused`` marks a result answered wholesale from a shared pair-verdict
    cache (the service layer's pair cache): no search ran for this call and
    ``stats`` carries only the avoided work.
    """

    verdict: Optional[bool]
    stats: VeerStats
    certificate: Optional[Certificate]
    config: VeerConfig
    reused: bool = False

    @property
    def equivalent(self) -> bool:
        return self.verdict is True

    @property
    def inequivalent(self) -> bool:
        return self.verdict is False

    @property
    def unknown(self) -> bool:
        return self.verdict is None

    @property
    def certified(self) -> bool:
        return self.certificate is not None

    def summary(self) -> str:
        v = {True: "EQ", False: "NEQ", None: "UNKNOWN"}[self.verdict]
        cert = self.certificate.summary() if self.certificate else "no certificate"
        return (
            f"{v} in {self.stats.total_time * 1e3:.1f} ms "
            f"({self.stats.ev_calls} EV calls, "
            f"{self.stats.ev_calls_saved} saved) — {cert}"
        )


def verify(
    P: DataflowDAG,
    Q: DataflowDAG,
    config: Optional[VeerConfig] = None,
    *,
    mapping: Optional[EditMapping] = None,
    registry: Optional[EVRegistry] = None,
    cache: Optional[VerdictCache] = None,
    veer: Optional[Veer] = None,
) -> VerificationResult:
    """Verify two dataflow versions; return verdict, stats and certificate.

    ``config`` defaults to Veer⁺ with the full default EV roster.  Pass
    ``cache`` to share one verdict store across calls (the config's
    ``cache_path`` is used otherwise), ``registry`` to resolve custom EV
    plugins, or a pre-built ``veer`` to reuse a wired verifier (the config
    then only documents the run).
    """
    config = config if config is not None else VeerConfig()
    registry = registry if registry is not None else default_registry()
    if veer is None:
        veer = config.build(registry, cache=cache)
    verdict, stats, evidence = veer.verify_with_evidence(
        P, Q, mapping, semantics=config.semantics
    )
    return VerificationResult(
        verdict=verdict,
        stats=stats,
        certificate=certificate_from_evidence(evidence),
        config=config,
    )
