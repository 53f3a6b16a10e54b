"""Reuse frontier: which Q operators a certificate lets Q reuse from P.

Veer's verdict answers *whether* two versions are equivalent; the frontier
answers *what that is worth at execution time* (the GEqO argument:
equivalence detection pays for itself only when it unlocks sub-plan /
materialization reuse).  Given a **True** ``Certificate`` for a verified
pair (P, Q) — and nothing else — ``compute_reuse_frontier`` derives the
maximal set of Q operators whose outputs are provably recoverable from
P's already-materialized outputs, in two tiers:

``exact``
    Operators identical under the certificate's edit mapping whose entire
    upstream cone is identical too (same signatures, same wiring, port for
    port, all the way to the sources).  The engine is deterministic and
    identity-free, so — *given the same source bindings* — the Q operator's
    output is **bit-identical** to the P operator's.  The engine layer
    enforces the source proviso mechanically: exact entries are only ever
    seeded when the Q operator's content digest equals the P operator's
    (``repro_torch.engine.executor.ExecutionPlan.digests``), which folds the
    concrete source bytes into the check.  Exact-tier reuse therefore
    never changes a single output byte.

``semantic``
    Sink operators of EV-verified windows whose in-boundary producers are
    all exact-tier: the window's query pair feeds both sides the *same*
    symbolic input (Def 3.4), so with bit-identical concrete inputs the
    EV's verdict transfers — the Q-side window sink's output equals the
    P-side's **under the certificate's table semantics** (bag/set/ordered
    equal, not necessarily byte-equal).  Sound to serve where Def 2.2
    equality is the contract (e.g. final sink results, the classic
    ``ReuseManager`` use case); *not* seeded into partial execution, which
    promises bit-identity.

Safety argument (the part the adversarial tests pin down): the frontier is
derived **only** from the certificate's bound pair.  ``compute_reuse_frontier``
first runs ``certificate.replay(registry, P, Q)`` — fresh, uncached EVs,
digest binding, fingerprint re-derivation, change-coverage — and raises
``FrontierError`` unless it is green, so a tampered, truncated, or
foreign-pair certificate yields *no* frontier rather than a wider one.
The exact tier is additionally self-verifying: it re-checks signatures and
wiring against P and Q directly, so even a maliciously-permuted mapping
cannot promote a non-identical cone.  Entries carry their provenance
(which rule, which window record) so a reuse decision can be audited back
to the certificate that justified it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.window import VersionPair

EXACT_TIER = "exact"
SEMANTIC_TIER = "semantic"
DELTA_TIER = "delta"


class FrontierError(ValueError):
    """The certificate cannot ground any reuse (wrong verdict, replay
    failure, or it does not bind to the given pair)."""


@dataclass(frozen=True)
class FrontierEntry:
    """One reusable operator: Q-side id, the P-side id whose materialized
    output stands in for it, the guarantee tier, and the provenance that
    justifies it (``identical-cone`` or ``window[i]`` — the certificate
    window record the semantic entry was derived from)."""

    q_op: str
    p_op: str
    tier: str
    provenance: str

    def to_dict(self) -> Dict[str, str]:
        return {
            "q_op": self.q_op,
            "p_op": self.p_op,
            "tier": self.tier,
            "provenance": self.provenance,
        }


@dataclass(frozen=True)
class ReuseFrontier:
    """The provably-reusable operator set for one certified pair.

    ``pair_digest`` ties the frontier to the same ``(P, Q, semantics)``
    the certificate was bound to; ``semantics`` qualifies what the
    semantic tier's equality means.
    """

    pair_digest: Optional[str]
    semantics: str
    mapping: Tuple[Tuple[str, str], ...]
    entries: Tuple[FrontierEntry, ...]

    @property
    def exact(self) -> Dict[str, str]:
        """Q-op → P-op for every bit-identical (exact-tier) entry."""
        return {e.q_op: e.p_op for e in self.entries if e.tier == EXACT_TIER}

    @property
    def semantic(self) -> Dict[str, str]:
        """Q-op → P-op for entries equal under the pair's semantics only."""
        return {e.q_op: e.p_op for e in self.entries if e.tier == SEMANTIC_TIER}

    def __len__(self) -> int:
        return len(self.entries)

    def coverage(self, Q: DataflowDAG) -> float:
        """Fraction of Q's operators the frontier covers."""
        return len(self.entries) / max(1, len(Q.ops))

    def summary(self) -> str:
        n_exact = sum(1 for e in self.entries if e.tier == EXACT_TIER)
        return (
            f"ReuseFrontier({len(self.entries)} ops: {n_exact} exact, "
            f"{len(self.entries) - n_exact} semantic; pair "
            f"{self.pair_digest or '?'})"
        )

    def to_dict(self) -> Dict[str, object]:
        return {
            "pair_digest": self.pair_digest,
            "semantics": self.semantics,
            "mapping": [[p, q] for p, q in self.mapping],
            "entries": [e.to_dict() for e in self.entries],
        }


def exact_frontier_map(
    P: DataflowDAG, Q: DataflowDAG, mapping: EditMapping
) -> Dict[str, str]:
    """Q-op → P-op for operators with fully-identical upstream cones.

    Bottom-up over Q's topological order: an operator qualifies iff it is
    mapped, its signature matches its P counterpart, and each input link
    (port for port) comes from an already-qualified producer whose P
    counterpart feeds the same port of the P operator.  Derived from P and
    Q directly — the mapping only proposes alignments, identity is
    re-checked from first principles.
    """
    bwd = mapping.backward
    exact: Dict[str, str] = {}
    for q_id in Q.topo_order():
        p_id = bwd.get(q_id)
        if p_id is None or p_id not in P.ops:
            continue
        if P.ops[p_id].signature() != Q.ops[q_id].signature():
            continue
        q_in = Q.in_links[q_id]
        p_in = P.in_links[p_id]
        if len(q_in) != len(p_in):
            continue
        # in_links are sorted by dst_port on both sides
        if all(
            lq.dst_port == lp.dst_port and exact.get(lq.src) == lp.src
            for lq, lp in zip(q_in, p_in)
        ):
            exact[q_id] = p_id
    return exact


def compute_reuse_frontier(
    certificate,
    P: DataflowDAG,
    Q: DataflowDAG,
    *,
    registry=None,
) -> ReuseFrontier:
    """Derive the reuse frontier for a certified-equivalent pair.

    Raises ``FrontierError`` unless ``certificate`` is a True verdict that
    **replays green bound to (P, Q)** — reuse is only ever taken on
    checked evidence, mirroring ``Certificate.replay``'s binding rules.
    """
    if certificate is None:
        raise FrontierError("no certificate — nothing grounds reuse")
    if certificate.verdict is not True:
        raise FrontierError(
            "only an equivalence (True) certificate grounds reuse"
        )
    report = certificate.replay(registry, P, Q)
    if not report.ok:
        raise FrontierError(
            f"certificate does not replay green for this pair: "
            f"{report.summary()}"
        )

    mapping = EditMapping(certificate.mapping)
    exact = exact_frontier_map(P, Q, mapping)
    entries: List[FrontierEntry] = [
        FrontierEntry(q, p, EXACT_TIER, "identical-cone")
        for q, p in exact.items()
    ]

    # semantic tier: window sinks of EV-verified windows whose in-boundary
    # producers are exact-tier (re-derived from the pair, never the
    # attacker-controllable payload)
    fwd = mapping.forward
    semantic: Dict[str, Tuple[str, str]] = {}
    if certificate.windows and certificate.kind == "decomposition":
        vp = VersionPair(P, Q, mapping, certificate.semantics)
        for i, rec in enumerate(certificate.windows):
            if rec.kind != "ev" or rec.verdict is not True:
                continue
            win = frozenset(rec.units)
            qp = vp.to_query_pair(win)
            if qp is None:
                continue  # replay(P, Q) would have flagged this; defensive
            p_in = vp.p_ops(win)
            producers = {
                l.src
                for op_id in p_in
                for l in P.in_links[op_id]
                if l.src not in p_in
            }
            if not all(exact.get(fwd.get(s)) == s for s in producers):
                continue
            for sp, sq in qp.sink_pairs:
                if sq not in exact and sq not in semantic:
                    semantic[sq] = (sp, f"window[{i}]")
    entries.extend(
        FrontierEntry(q, p, SEMANTIC_TIER, prov)
        for q, (p, prov) in semantic.items()
    )
    entries.sort(key=lambda e: (e.tier, e.q_op))
    return ReuseFrontier(
        pair_digest=certificate.pair_digest,
        semantics=certificate.semantics,
        mapping=certificate.mapping,
        entries=tuple(entries),
    )


def compute_delta_plan(frontier: ReuseFrontier, P: DataflowDAG, Q: DataflowDAG):
    """Delta-tier gate: the O(|Δrows|) plan for a certified pair, or None.

    Certificate-gated exactly like the exact/semantic tiers: callers must
    pass a ``ReuseFrontier`` obtained from ``compute_reuse_frontier`` —
    i.e. derived from a True certificate that replayed green for (P, Q).
    The delta analysis itself (``repro_torch.core.delta``) re-checks signatures,
    wiring and amenability from P and Q directly, so the frontier only
    contributes the mapping and the exact-tier region it already verified.
    """
    from repro_torch.core.delta import analyze_delta

    return analyze_delta(
        P, Q, EditMapping(frontier.mapping), exact=frontier.exact
    )
