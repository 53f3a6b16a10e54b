"""Spes-style EV [58]: SPJ under Bag semantics, linear predicates.

Complete in its fragment (bag-equivalence of linear-SPJ is canonical-form
isomorphism), so it IS inequivalence-capable there, and it is
restriction-monotonic (§5.5: adding any operator to an invalid window keeps
it invalid, since validity = "all ops are SPJ with linear predicates").

Supported fragment (format shared by all EVs; see docs/ARCHITECTURE.md):

    ============== ==========================================================
    EV             SpesEV (``spes``)
    Operators      Source, Filter, Project, Join(inner), Replicate, Sink
    Semantics      bag, set (a bag proof implies set equality)
    Restrictions   S1 operators restricted to SPJ; S2 predicates linear
    Monotonic      yes (Def 5.9)
    Proves inequiv yes — complete in its fragment
    ============== ==========================================================
"""

from __future__ import annotations

from typing import FrozenSet, List, Optional

from repro_torch.core import dag as D
from repro_torch.core.dag import BAG, SET
from repro_torch.core.ev import relational as R
from repro_torch.core.ev.base import BaseEV, QueryPair, Restriction

_SUPPORTED = frozenset({D.SOURCE, D.FILTER, D.PROJECT, D.JOIN, D.REPLICATE, D.SINK})


class SpesEV(BaseEV):
    name = "spes"
    semantics = frozenset({BAG, SET})  # bag proof ⇒ set equality too
    restriction_monotonic = True
    can_prove_inequivalence = True
    supported_op_types = _SUPPORTED

    def restrictions(self) -> List[Restriction]:
        return [
            Restriction("S1", "operators restricted to Select-Project-Join"),
            Restriction("S2", "predicates must be linear"),
        ]

    def failed_restrictions(self, qp: QueryPair) -> List[str]:
        failed = []
        for dag in (qp.P, qp.Q):
            for op in dag.ops.values():
                if op.op_type not in _SUPPORTED:
                    failed.append("S1")
                elif op.op_type == D.JOIN and op.get("how", "inner") != "inner":
                    failed.append("S1")
                elif op.op_type == D.FILTER and not op.get("pred").is_linear():
                    failed.append("S2")
        return sorted(set(failed))

    def validate(self, qp: QueryPair) -> bool:
        if qp.semantics not in self.semantics:
            return False
        return not self.failed_restrictions(qp)

    def check(self, qp: QueryPair) -> Optional[bool]:
        try:
            for ps, qs in qp.sink_pairs:
                a = R.normalize(qp.P, ps, allow_union=False)
                b = R.normalize(qp.Q, qs, allow_union=False)
                if not (R.is_spj_only(a) and R.is_spj_only(b)):
                    return None
                if not R.blocks_equivalent(a, b):
                    return False  # complete fragment ⇒ sound inequivalence
            return True
        except R.UnsupportedOp:
            return None


class UDPEV(BaseEV):
    """UDP-style EV [15]: Union-SPJ under bag semantics (semiring model).

    Third EV demonstrating §8 "Using multiple EVs": it covers Union windows
    that Equitas/Spes reject, so multi-EV Veer verifies W3/W4-style workflows
    without segmentation boundaries at every Union.

    Supported fragment (format shared by all EVs; see docs/ARCHITECTURE.md):

        ============== ======================================================
        EV             UDPEV (``udp``)
        Operators      Source, Filter, Project, Join(inner), Union,
                       Replicate, Sink
        Semantics      bag, set
        Restrictions   U1 operators restricted to Union-SPJ; U2 predicates
                       linear
        Monotonic      yes
        Proves inequiv only in the union-free sub-fragment (branch-wise
                       bijection is incomplete across Union)
        ============== ======================================================
    """

    name = "udp"
    semantics = frozenset({BAG, SET})
    restriction_monotonic = True
    can_prove_inequivalence = True
    supported_op_types = _SUPPORTED | frozenset({D.UNION})

    def restrictions(self) -> List[Restriction]:
        return [
            Restriction("U1", "operators restricted to Union-SPJ"),
            Restriction("U2", "predicates must be linear"),
        ]

    def failed_restrictions(self, qp: QueryPair) -> List[str]:
        failed = []
        for dag in (qp.P, qp.Q):
            for op in dag.ops.values():
                if op.op_type not in self.supported_op_types:
                    failed.append("U1")
                elif op.op_type == D.JOIN and op.get("how", "inner") != "inner":
                    failed.append("U1")
                elif op.op_type == D.FILTER and not op.get("pred").is_linear():
                    failed.append("U2")
        return sorted(set(failed))

    def validate(self, qp: QueryPair) -> bool:
        if qp.semantics not in self.semantics:
            return False
        return not self.failed_restrictions(qp)

    def check(self, qp: QueryPair) -> Optional[bool]:
        try:
            for ps, qs in qp.sink_pairs:
                a = R.normalize(qp.P, ps, allow_union=True)
                b = R.normalize(qp.Q, qs, allow_union=True)
                if not R.blocks_equivalent(a, b):
                    # Branch-wise bijection is sound for True but NOT complete
                    # for unions (e.g. σ_{x<5}R ∪ σ_{x≥5}R ≡ R), so a mismatch
                    # only proves inequivalence in the union-free fragment.
                    if R.is_spj_only(a) and R.is_spj_only(b):
                        return False
                    return None
            return True
        except R.UnsupportedOp:
            return None
