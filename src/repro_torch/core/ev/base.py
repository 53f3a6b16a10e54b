"""EV protocol (paper §2.3, §4.2).

An EV takes a pair of queries and returns True (equivalent), False
(inequivalent) or None (Unknown).  Each EV publishes *restrictions* — a
validator deciding whether a window/query pair is inside the fragment the EV
can decide (Def 4.2/4.3) — plus two capability bits the verifier relies on:

  * ``restriction_monotonic`` (Def 5.9): expanding an invalid window can
    never make it valid.  Spes-like EVs have it; Equitas-like do not (R5/R6
    counting restrictions), which changes how Algorithm 2 marks maximality.
  * ``can_prove_inequivalence``: only such EVs may drive a False verdict
    (paper §4.4 note about COSETTE).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.dag import BAG, ORDERED, SET, SOURCE, DataflowDAG


@dataclass(frozen=True)
class QueryPair:
    """Two stand-alone sub-DAGs with aligned symbolic sources and sinks.

    Source operators carry the *same id* on both sides (the window boundary
    correspondence), so "for every instance of source operators" (Def 3.4)
    means binding equal tables to equal ids.
    """

    P: DataflowDAG
    Q: DataflowDAG
    sink_pairs: Tuple[Tuple[str, str], ...]
    semantics: str = BAG
    at_version_sink: bool = False  # window sinks are the versions' sinks

    def key(self) -> Tuple:
        return (
            self.P.signature(),
            self.Q.signature(),
            self.sink_pairs,
            self.semantics,
            self.at_version_sink,
        )

    def fingerprint(self) -> str:
        """Content-addressed canonical key, invariant under operator renames.

        ``key()`` above is id-sensitive: the same rewrite applied to a renamed
        copy of a workflow (or re-encountered in a later version pair, where
        ids drifted) produces a different key.  ``fingerprint()`` erases ids —
        operators are named by their position in a canonical traversal, and
        source operators by a token assigned on first appearance that is
        *shared across the two sides* (same source id on both sides ⇒ same
        token, which is exactly the pairing EV verdicts depend on).  Two
        query pairs with equal fingerprints are isomorphic as pairs, so every
        (deterministic, id-invariant) EV returns the same verdict on both —
        the soundness condition for the cross-version verdict cache.

        Canonicalization: each sink pair serializes both sub-DAG cones in
        consumer-port order, with internal sharing captured by back-references
        (``("ref", i)``); sink pairs are ordered by an id-free local
        serialization first, so the global source-token assignment does not
        depend on the incoming ``sink_pairs`` order.
        """
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        pairs = []
        for ps, qs in self.sink_pairs:
            tokens: Dict[str, int] = {}
            local: List[Tuple] = []
            _canon_cone(self.P, ps, tokens, {}, local)
            local.append(("side",))
            _canon_cone(self.Q, qs, tokens, {}, local)
            pairs.append((repr(local), ps, qs))
        pairs.sort(key=lambda x: x[0])
        tokens = {}
        ix_p: Dict[str, int] = {}
        ix_q: Dict[str, int] = {}
        stream: List[Tuple] = []
        for _, ps, qs in pairs:
            stream.append(("sink",))
            _canon_cone(self.P, ps, tokens, ix_p, stream)
            stream.append(("side",))
            _canon_cone(self.Q, qs, tokens, ix_q, stream)
        blob = repr((self.semantics, self.at_version_sink, stream))
        digest = hashlib.sha256(blob.encode()).hexdigest()[:32]
        object.__setattr__(self, "_fingerprint", digest)  # frozen-safe memo
        return digest


def _canon_cone(
    dag: DataflowDAG,
    root: str,
    source_tokens: Dict[str, int],
    node_ix: Dict[str, int],
    out: List[Tuple],
) -> None:
    """Append an id-free serialization of the cone feeding ``root`` to ``out``.

    The stream is flat (balanced ``begin``/``end`` markers instead of nested
    tuples) and the traversal iterative, so arbitrarily deep pipelines neither
    overflow the interpreter stack nor break ``repr``.  Non-source operators
    are indexed in post-order of first completion; revisits (fan-out sharing)
    serialize as ``("ref", index)``.  Sources serialize as
    ``("src", token, signature)`` where the token dict is shared between the
    P and Q sides of a pair (ids coincide there by construction), making the
    cross-side source correspondence part of the canonical form.
    """
    stack: List[Tuple[str, str]] = [("visit", root)]
    while stack:
        action, op_id = stack.pop()
        if action == "end":
            node_ix[op_id] = len(node_ix)
            out.append(("end",))
            continue
        op = dag.ops[op_id]
        if op.op_type == SOURCE:
            tok = source_tokens.setdefault(op_id, len(source_tokens))
            out.append(("src", tok, op.signature()))
            continue
        if op_id in node_ix:
            out.append(("ref", node_ix[op_id]))
            continue
        out.append(("begin", op.signature()))
        stack.append(("end", op_id))
        for l in reversed(dag.in_links.get(op_id, ())):
            stack.append(("visit", l.src))


@dataclass(frozen=True)
class Restriction:
    """One named EV restriction, e.g. Equitas R1..R6 (§4.2)."""

    name: str
    description: str


class BaseEV:
    name: str = "base"
    semantics: FrozenSet[str] = frozenset({SET, BAG, ORDERED})
    restriction_monotonic: bool = False
    can_prove_inequivalence: bool = False
    supported_op_types: FrozenSet[str] = frozenset()

    def restrictions(self) -> List[Restriction]:
        return []

    def validate(self, qp: QueryPair) -> bool:
        """True iff the pair satisfies this EV's restrictions (valid window,
        Def 4.3)."""
        raise NotImplementedError

    def failed_restrictions(self, qp: QueryPair) -> List[str]:
        """Names of violated restrictions (for Table-1-style reporting)."""
        return [] if self.validate(qp) else ["unspecified"]

    def check(self, qp: QueryPair) -> Optional[bool]:
        """Equivalence verdict; callers must have validated first."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"EV({self.name})"


class EVCallCounter:
    """Wraps an EV to count/check calls — the experiments report EV-call
    overhead separately (paper Table 6)."""

    def __init__(self, ev: BaseEV):
        self.ev = ev
        self.calls = 0
        self.validate_calls = 0
        self.time_in_check = 0.0

    def __getattr__(self, item):
        return getattr(self.ev, item)

    def validate(self, qp: QueryPair) -> bool:
        self.validate_calls += 1
        return self.ev.validate(qp)

    def check(self, qp: QueryPair) -> Optional[bool]:
        import time

        self.calls += 1
        t0 = time.perf_counter()
        try:
            return self.ev.check(qp)
        finally:
            self.time_in_check += time.perf_counter() - t0
