"""Edit operations, transformations, and edit mappings (paper §2.1, Def 2.1).

Five edit operations: add/delete operator, modify operator properties,
add/remove link.  A *transformation* δ is an aggregated set of edits;
``apply_transformation(P, δ) = Q`` (Eq. 1: v_{j+1} = v_j ⊕ δ_j).

An *edit mapping* M aligns every operator of P to at most one operator of Q
(injective partial map); unmapped P-ops are deletions, unmapped Q-ops are
insertions (paper Fig 2/3).  Different mappings yield different edit sets —
§5.5(2) shows minimum edit distance is not always best, so we expose
``enumerate_mappings`` for the verifier to try alternatives.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.dag import DAGError, DataflowDAG, Link, Operator

# ---------------------------------------------------------------------------
# Edit operations (Def 2.1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AddOperator:
    op: Operator

    def apply(self, dag: DataflowDAG) -> DataflowDAG:
        return dag.add_op(self.op)

    def key(self):
        return ("add_op", self.op.id)


@dataclass(frozen=True)
class DeleteOperator:
    op_id: str

    def apply(self, dag: DataflowDAG) -> DataflowDAG:
        return dag.remove_op(self.op_id)

    def key(self):
        return ("del_op", self.op_id)


@dataclass(frozen=True)
class ModifyOperator:
    """Properties change; operator type stays the same (Def 2.1)."""

    op_id: str
    new_props: Tuple[Tuple[str, object], ...]

    @staticmethod
    def make(op_id: str, **props) -> "ModifyOperator":
        return ModifyOperator(op_id, tuple(sorted(props.items())))

    def apply(self, dag: DataflowDAG) -> DataflowDAG:
        old = dag.ops[self.op_id]
        return dag.replace_op(Operator(old.id, old.op_type, self.new_props))

    def key(self):
        return ("mod_op", self.op_id)


@dataclass(frozen=True)
class AddLink:
    link: Link

    def apply(self, dag: DataflowDAG) -> DataflowDAG:
        return dag.add_link(self.link)

    def key(self):
        return ("add_link",) + self.link.key()


@dataclass(frozen=True)
class RemoveLink:
    link: Link

    def apply(self, dag: DataflowDAG) -> DataflowDAG:
        return dag.remove_link(self.link)

    def key(self):
        return ("del_link",) + self.link.key()


EditOp = object  # union of the five classes above
Transformation = Tuple[EditOp, ...]


def apply_transformation(dag: DataflowDAG, delta: Sequence[EditOp]) -> DataflowDAG:
    """v ⊕ δ. Order-tolerant: op additions first, link removals before op
    removals, link additions last — so users can list edits in any order."""

    def rank(e: EditOp) -> int:
        if isinstance(e, AddOperator):
            return 0
        if isinstance(e, ModifyOperator):
            return 1
        if isinstance(e, RemoveLink):
            return 2
        if isinstance(e, DeleteOperator):
            return 3
        return 4  # AddLink

    out = dag
    for e in sorted(delta, key=rank):
        out = e.apply(out)
    out.validate()
    return out


# ---------------------------------------------------------------------------
# Edit mapping (paper §2.1 "Workflow edit mapping")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EditMapping:
    """Injective partial map P-op-id -> Q-op-id."""

    p_to_q: Tuple[Tuple[str, str], ...]

    @staticmethod
    def make(pairs: Mapping[str, str]) -> "EditMapping":
        vals = list(pairs.values())
        if len(set(vals)) != len(vals):
            raise ValueError("mapping not injective")
        return EditMapping(tuple(sorted(pairs.items())))

    # cached_property writes straight into __dict__, which bypasses the
    # frozen-dataclass __setattr__ guard — equality/hash still use only
    # p_to_q.  The search kernel reads these maps in inner loops (boundary
    # checks, identity payloads), so rebuilding a dict per access showed up
    # in profiles.  Callers must not mutate the returned dicts.
    @cached_property
    def forward(self) -> Dict[str, str]:
        return dict(self.p_to_q)

    @cached_property
    def backward(self) -> Dict[str, str]:
        return {q: p for p, q in self.p_to_q}

    def __contains__(self, p_id: str) -> bool:
        return p_id in self.forward

    def __call__(self, p_id: str) -> Optional[str]:
        return self.forward.get(p_id)


def identity_mapping(P: DataflowDAG, Q: DataflowDAG) -> EditMapping:
    """Map operators that share ids — the natural mapping when edits are
    *tracked* by the version-control layer (ids are stable across versions)."""
    return EditMapping.make({i: i for i in P.ops if i in Q.ops})


def diff(
    P: DataflowDAG, Q: DataflowDAG, mapping: Optional[EditMapping] = None
) -> List[EditOp]:
    """Derive the edit set corresponding to a mapping (paper Fig 3)."""
    if mapping is None:
        mapping = identity_mapping(P, Q)
    fwd = mapping.forward
    bwd = mapping.backward
    edits: List[EditOp] = []
    for p_id, op in P.ops.items():
        q_id = fwd.get(p_id)
        if q_id is None:
            edits.append(DeleteOperator(p_id))
        else:
            q_op = Q.ops[q_id]
            if q_op.op_type != op.op_type:
                raise ValueError(
                    f"mapping aligns different op types {op} -> {q_op}"
                )
            if q_op.signature() != op.signature():
                edits.append(ModifyOperator(q_id, q_op.properties))
    for q_id, op in Q.ops.items():
        if q_id not in bwd:
            edits.append(AddOperator(op))
    # links: a P-link maps to a Q-link when both endpoints map and ports match
    p_links = {l.key(): l for l in P.links}
    q_links = {l.key(): l for l in Q.links}
    mapped_q_keys: Set[Tuple[str, str, int]] = set()
    for l in P.links:
        qs, qd = fwd.get(l.src), fwd.get(l.dst)
        qkey = (qs, qd, l.dst_port)
        if qs is not None and qd is not None and qkey in q_links:
            mapped_q_keys.add(qkey)
        else:
            edits.append(RemoveLink(l))
    for l in Q.links:
        if l.key() not in mapped_q_keys:
            edits.append(AddLink(l))
    return edits


def link_mapping(
    P: DataflowDAG, Q: DataflowDAG, mapping: EditMapping
) -> Dict[Tuple[str, str, int], Tuple[str, str, int]]:
    """P-link-key -> Q-link-key for links preserved by the mapping."""
    fwd = mapping.forward
    q_keys = {l.key() for l in Q.links}
    out: Dict[Tuple[str, str, int], Tuple[str, str, int]] = {}
    for l in P.links:
        qs, qd = fwd.get(l.src), fwd.get(l.dst)
        if qs is not None and qd is not None and (qs, qd, l.dst_port) in q_keys:
            out[l.key()] = (qs, qd, l.dst_port)
    return out


def enumerate_mappings(
    P: DataflowDAG, Q: DataflowDAG, limit: int = 16
) -> List[EditMapping]:
    """Candidate edit mappings, best-first (§5.5(2)).

    First the tracked/identity mapping, then (a) *swap* variants re-aligning
    same-type mapped operators whose links changed (an operator swap under
    identity becomes pure modifies under the swapped mapping — paper Fig 3's
    M1 vs M2), then (b) variants aligning same-type unmapped operators
    (delete+insert → modify).
    """
    base = identity_mapping(P, Q)
    out = [base]
    # (a) swap variants among mapped ops incident to link edits
    link_incident: Set[str] = set()
    for e in diff(P, Q, base):
        if isinstance(e, RemoveLink):
            link_incident.add(e.link.src)
            link_incident.add(e.link.dst)
        elif isinstance(e, AddLink):
            link_incident.add(e.link.src)
            link_incident.add(e.link.dst)
    cands = [
        i for i in sorted(link_incident)
        if i in base.forward and i in P.ops and base.forward[i] in Q.ops
    ]
    for a, b in itertools.combinations(cands, 2):
        if P.ops[a].op_type != P.ops[b].op_type:
            continue
        pairs = dict(base.forward)
        pairs[a], pairs[b] = pairs[b], pairs[a]
        try:
            out.append(EditMapping.make(pairs))
        except ValueError:
            continue
        if len(out) >= limit:
            return out
    fwd = base.forward
    un_p = [i for i in P.ops if i not in fwd]
    un_q = [i for i in Q.ops if i not in set(fwd.values())]
    # group by op type
    by_type_q: Dict[str, List[str]] = {}
    for q in un_q:
        by_type_q.setdefault(Q.ops[q].op_type, []).append(q)
    candidates: List[List[Tuple[str, str]]] = []
    for p in un_p:
        t = P.ops[p].op_type
        opts = [(p, q) for q in by_type_q.get(t, [])]
        if opts:
            candidates.append(opts)
    # all combinations of independent re-alignments (bounded)
    for r in range(1, len(candidates) + 1):
        for combo in itertools.combinations(candidates, r):
            for choice in itertools.product(*combo):
                used_q = [q for _, q in choice]
                if len(set(used_q)) != len(used_q):
                    continue
                pairs = dict(fwd)
                for p, q in choice:
                    pairs[p] = q
                try:
                    out.append(EditMapping.make(pairs))
                except ValueError:
                    continue
                if len(out) >= limit:
                    return out
    return out
