"""Seeded adversarial edit-session generator.

Veer's setting is *iterative* analytics: an analyst evolves one dataflow
through many small edits, and the verifier sees the resulting chain of
versions.  ``SessionGenerator`` samples such chains over the paper's W1-W8
shapes, drawing each step from five edit families:

  * ``equivalent``   — Calcite-preserving rewrites
    (``repro_torch.workload.workloads.apply_equivalent_edits``); the pair is
    equivalent *by construction*, so the differential oracle may demand an
    execution-equal sink on every source binding.
  * ``semantic``     — TPC-DS-iterative semantic edits
    (``apply_inequivalent_edits``).  Ground truth is open: a bumped filter
    constant usually changes the sink but need not (the verifier itself
    proved one such edit equivalent on W4), so these pairs carry
    ``expected="any"`` and only the verdict-vs-execution cross-check runs.
  * ``boundary``     — two empty-filter edits 0-2 one-to-one hops apart
    (``edits_with_distance``), the paper's Fig 26 window-boundary stress.
  * ``rename_storm`` — every interior operator id is rewritten while
    SOURCE/SINK ids stay stable; the explicit ``EditMapping`` carries the
    correspondence.  Content is untouched, so the pair must come back EQ
    (operator signatures are identity-free) — this stresses the mapping
    plumbing end to end.
  * ``churn_revert`` — apply an equivalent edit, revert it, re-apply it
    with byte-identical operator ids.  The third pair is content-identical
    to the first, so a service sharing a ``PairVerdictCache`` must answer
    it without a second search.

Determinism contract: one ``random.Random`` per session, derived from
``(config.seed, session index)``; ``random_tables`` gets an integer seed
from the same stream.  Same config ⇒ byte-identical sessions
(``EditSession.signature()`` is the regression hook).
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.edits import EditMapping
from repro_torch.core.serialize import dag_to_dict
from repro_torch.engine.store import table_digest
from repro_torch.engine.table import Table
from repro_torch.workload.config import WorkloadConfig
from repro_torch.workload.workloads import (
    WORKLOADS,
    apply_equivalent_edits,
    apply_inequivalent_edits,
    edits_with_distance,
    random_tables,
)

# expected verdict classes a planned pair can carry:
#   "eq"  — equivalent by construction; a False verdict or an
#           execution-unequal sink is an oracle violation
#   "any" — ground truth open; only decided-verdict-vs-execution and
#           certificate-replay checks apply
EXPECTED_EQ = "eq"
EXPECTED_ANY = "any"


@dataclass(frozen=True)
class PlannedPair:
    """One consecutive version pair of a session, with its oracle label.

    ``index`` is the pair index: pair k relates versions k-1 and k.
    ``mapping`` is the tracked edit mapping (None ⇒ id-stable identity),
    exactly what the session passes to ``VerificationService.submit``.
    """

    index: int
    kind: str                       # edit family that produced version k
    expected: str                   # EXPECTED_EQ | EXPECTED_ANY
    mapping: Optional[EditMapping] = None


@dataclass
class EditSession:
    """One generated multi-version edit session (a single service client)."""

    session_id: str
    workload: str                   # W1..W8 shape the chain started from
    versions: List[DataflowDAG]
    pairs: List[PlannedPair]        # len(versions) - 1 entries
    sources: Dict[str, Table]       # bindings for the shape's Source ops
    seed: int = 0

    def __post_init__(self) -> None:
        if len(self.pairs) != len(self.versions) - 1:
            raise ValueError(
                f"session {self.session_id}: {len(self.versions)} versions "
                f"need {len(self.versions) - 1} pairs, got {len(self.pairs)}"
            )

    def signature(self) -> str:
        """Content digest of everything the session determines: every
        version DAG, every pair label/mapping, every source table.  Two
        same-seed generator runs must produce equal signatures — the
        byte-identity regression test hashes exactly this."""
        h = hashlib.sha256()
        h.update(self.session_id.encode())
        h.update(self.workload.encode())
        for v in self.versions:
            h.update(json.dumps(dag_to_dict(v), sort_keys=True).encode())
        for p in self.pairs:
            fwd = sorted(p.mapping.forward.items()) if p.mapping else None
            h.update(json.dumps(
                [p.index, p.kind, p.expected, fwd]
            ).encode())
        for sid in sorted(self.sources):
            h.update(sid.encode())
            h.update(table_digest(self.sources[sid]).encode())
        return h.hexdigest()


def _rename_storm(
    dag: DataflowDAG, rng: random.Random, prefix: str
) -> Tuple[DataflowDAG, EditMapping]:
    """Rewrite every interior operator id; SOURCE/SINK ids stay stable.

    Source ids key the bound tables and sink ids key the oracle's result
    comparison, so the storm never touches them.  Returns the renamed DAG
    plus the full explicit mapping (old id → new id for every operator) —
    with it the pair has *zero* changes (signatures are identity-free) and
    must certify EXACT.
    """
    renames: Dict[str, str] = {}
    interior = [
        o for o in dag.ops.values() if o.op_type not in (D.SOURCE, D.SINK)
    ]
    for j, o in enumerate(sorted(interior, key=lambda o: o.id)):
        renames[o.id] = f"{prefix}r{j}_{rng.randrange(16 ** 6):06x}"
    new_ops = [
        Operator.make(renames.get(o.id, o.id), o.op_type, **o.props)
        for o in dag.ops.values()
    ]
    new_links = [
        Link(renames.get(l.src, l.src), renames.get(l.dst, l.dst), l.dst_port)
        for l in dag.links
    ]
    q = DataflowDAG(new_ops, new_links)
    q.validate()
    mapping = EditMapping.make(
        {o.id: renames.get(o.id, o.id) for o in dag.ops.values()}
    )
    return q, mapping


def _predicate_edit(
    dag: DataflowDAG, rng: random.Random
) -> Optional[DataflowDAG]:
    """Narrow (p ∧ x) or widen (p ∨ x) one FILTER's predicate in place.

    The canonical delta-amenable edit family: the operator id is
    kept, so the id-stable identity mapping aligns the pair and the delta
    analysis (``repro_torch.core.delta``) classifies the boundary as
    narrow / widen / filter-general.  ``p ∧ x ⇒ p`` and ``p ⇒ p ∨ x`` hold
    for *any* conjunct/disjunct, so a narrow step is provably
    delete-only and a widen step insert-only whenever the EV solver
    supports the predicate's atoms.  Returns ``None`` when the shape has
    no filter over at least one column.
    """
    from repro_torch.core.predicates import Pred

    candidates = [
        o for o in sorted(dag.ops.values(), key=lambda o: o.id)
        if o.op_type == D.FILTER
        and o.get("pred") is not None
        and o.get("pred").columns
    ]
    if not candidates:
        return None
    op = rng.choice(candidates)
    pred = op.get("pred")
    col = rng.choice(sorted(pred.columns))
    cmp_op = rng.choice(["<=", "<", ">=", ">"])
    bound = rng.choice([-2, -1, 0, 1, 2, 3, 5]) + rng.choice([0.0, 0.5])
    atom = Pred.cmp(col, cmp_op, bound)
    if rng.random() < 0.5:
        new_pred = Pred.and_(pred, atom)     # narrow: delete-only delta
    else:
        new_pred = Pred.or_(pred, atom)      # widen: insert-only delta
    q = dag.replace_op(op.with_props(pred=new_pred))
    q.validate()
    return q


class SessionGenerator:
    """Samples deterministic multi-version edit sessions from a config.

    One generator instance is stateless across calls: ``generate()`` (or
    ``session(i)``) always derives each session's RNG from
    ``(config.seed, i)``, so sessions can be regenerated independently and
    in any order.
    """

    def __init__(self, config: WorkloadConfig):
        self.config = config.validate()
        mix = config.mix
        self._families = list(mix)
        self._weights = [mix[f] for f in self._families]

    # -- public API ----------------------------------------------------------
    def generate(self) -> List["EditSession"]:
        return [self.session(i) for i in range(self.config.sessions)]

    def iter_sessions(self) -> Iterator["EditSession"]:
        for i in range(self.config.sessions):
            yield self.session(i)

    def session(self, i: int) -> "EditSession":
        cfg = self.config
        seed = cfg.seed * 1_000_003 + i
        rng = random.Random(seed)
        workload = rng.choice(list(cfg.workloads))
        base = WORKLOADS[workload]()
        sources = random_tables(base, seed=rng.randrange(2**31), n=cfg.rows)
        versions: List[DataflowDAG] = [base]
        pairs: List[PlannedPair] = []
        while len(versions) < cfg.chain_length:
            family = rng.choices(self._families, weights=self._weights)[0]
            self._apply_family(family, versions, pairs, rng, i)
        # churn_revert can overshoot by up to 2 versions; trim to spec so
        # every session has exactly chain_length versions
        del versions[cfg.chain_length:]
        del pairs[cfg.chain_length - 1:]
        return EditSession(
            session_id=f"s{i}",
            workload=workload,
            versions=versions,
            pairs=pairs,
            sources=sources,
            seed=seed,
        )

    # -- family application ---------------------------------------------------
    def _apply_family(
        self,
        family: str,
        versions: List[DataflowDAG],
        pairs: List[PlannedPair],
        rng: random.Random,
        session_index: int,
    ) -> None:
        cfg = self.config
        cur = versions[-1]
        k = len(versions)  # pair index of the version being appended
        prefix = f"s{session_index}v{k}_"

        def push(q, kind, expected, mapping=None):
            versions.append(q)
            pairs.append(PlannedPair(len(versions) - 1, kind, expected, mapping))

        if family == "equivalent":
            n = rng.randint(1, cfg.max_edits_per_version)
            q = apply_equivalent_edits(cur, n, rng=rng, prefix=prefix)
            push(q, "equivalent", EXPECTED_EQ)
        elif family == "semantic":
            n = rng.randint(1, cfg.max_edits_per_version)
            q = apply_inequivalent_edits(cur, n, rng=rng, prefix=prefix)
            push(q, "semantic", EXPECTED_ANY)
        elif family == "boundary":
            hops = rng.choice([0, 1, 2])
            try:
                q = edits_with_distance(cur, hops, prefix=f"{prefix}fe")
            except ValueError:
                # no long-enough 1-1 chain left in this shape: degrade to a
                # single empty-filter splice (still a boundary-adjacent edit)
                q = apply_equivalent_edits(
                    cur, 1, rng=rng, kinds=["empty_filter"], prefix=prefix
                )
            push(q, "boundary", EXPECTED_EQ)
        elif family == "rename_storm":
            q, mapping = _rename_storm(cur, rng, prefix)
            push(q, "rename_storm", EXPECTED_EQ, mapping)
        elif family == "predicate":
            q = _predicate_edit(cur, rng)
            if q is None:
                # shape has no filter with a linear predicate left: degrade
                # to a semantic edit so the chain keeps its planned length
                q = apply_inequivalent_edits(cur, 1, rng=rng, prefix=prefix)
            push(q, "predicate", EXPECTED_ANY)
        elif family == "churn_revert":
            # A → B → A → B with one frozen RNG for both B constructions:
            # the second A→B pair is content-identical to the first and must
            # be answered from the shared PairVerdictCache without a search.
            churn_seed = rng.randrange(2**31)
            a = cur
            b = apply_equivalent_edits(
                a, 1, rng=random.Random(churn_seed), prefix=prefix
            )
            push(b, "churn_revert", EXPECTED_EQ)
            if len(versions) < cfg.chain_length:
                push(a, "churn_revert", EXPECTED_EQ)
            if len(versions) < cfg.chain_length:
                b2 = apply_equivalent_edits(
                    a, 1, rng=random.Random(churn_seed), prefix=prefix
                )
                push(b2, "churn_revert", EXPECTED_EQ)
        else:  # pragma: no cover - config.validate() rejects unknown families
            raise ValueError(f"unknown edit family {family!r}")
