"""Dataflow DAG model (paper §2).

A workflow ``W`` is a DAG of operators; each operator has a *property*
(computation function parameters).  Operators without incoming links are
Sources, without outgoing links are Sinks.  Links are ordered at the consumer
(``dst_port``) because Join/LeftOuterJoin distinguish left/right inputs.

The same DAG class doubles as the *query* representation handed to EVs: a
window's sub-DAG pair is exported with symbolic source operators standing in
for the cut boundary (§4.1).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.predicates import LinExpr, Pred

# ---------------------------------------------------------------------------
# Operator types
# ---------------------------------------------------------------------------

# Relational core (what published EVs reason about, §4.2)
SOURCE = "Source"
FILTER = "Filter"
PROJECT = "Project"
JOIN = "Join"                 # properties: on=[(l,r)...], how=inner|left_outer
AGGREGATE = "Aggregate"       # properties: group_by=[...], aggs=[(fn,col,out)...]
UNION = "Union"
DISTINCT = "Distinct"
SORT = "Sort"                 # properties: keys=[(col, asc)...]
LIMIT = "Limit"               # properties: n
UNNEST = "Unnest"             # properties: col, out
REPLICATE = "Replicate"       # fan-out marker (multiple outgoing links)

# Semantically-rich operators (trait T1 — the reason existing EVs fail)
UDF = "UDF"                   # properties: fn, out_schema / jax_fn name
DICT_MATCHER = "DictionaryMatcher"  # properties: col, entries, out
CLASSIFIER = "Classifier"     # properties: col, model, out
SENTIMENT = "SentimentAnalyzer"

# Framework compute operators (the expensive steps Veer makes reusable)
TRAIN_STEP = "TrainStep"      # properties: arch, shape, steps
SERVE_STEP = "ServeStep"
TOKENIZE = "TokenizePack"     # data-pipeline operator

SINK = "Sink"                 # properties: semantics in {set,bag,ordered}

RELATIONAL_OPS = {SOURCE, FILTER, PROJECT, JOIN, AGGREGATE, UNION, DISTINCT,
                  SORT, LIMIT, UNNEST, REPLICATE, SINK}
ML_OPS = {UDF, DICT_MATCHER, CLASSIFIER, SENTIMENT, TRAIN_STEP, SERVE_STEP, TOKENIZE}

_ARITY = {JOIN: 2, UNION: 2}   # everything else: 1 input (SOURCE: 0)

SET, BAG, ORDERED = "set", "bag", "ordered"


def _canon(v: Any) -> Any:
    """Canonical, hashable view of a property value."""
    if isinstance(v, Pred):
        return v.key()
    if isinstance(v, LinExpr):
        return v.key()
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(map(_canon, v)))
    return v


@dataclass(frozen=True)
class Operator:
    """A DAG vertex: identity + type + properties."""

    id: str
    op_type: str
    properties: Tuple[Tuple[str, Any], ...] = ()

    @staticmethod
    def make(id: str, op_type: str, **properties: Any) -> "Operator":
        return Operator(id, op_type, tuple(sorted(properties.items())))

    @property
    def props(self) -> Dict[str, Any]:
        return dict(self.properties)

    def get(self, key: str, default: Any = None) -> Any:
        return self.props.get(key, default)

    def with_props(self, **kv: Any) -> "Operator":
        p = self.props
        p.update(kv)
        return Operator(self.id, self.op_type, tuple(sorted(p.items())))

    def signature(self) -> Tuple:
        """Type+properties (identity-free) — equal signatures ⇒ same computation.

        Memoized per instance (frozen-safe): operators are shared between a
        DAG and every window sub-DAG induced from it, and the search kernel's
        fingerprint/identity checks hit ``signature`` on every distinct
        window — canonicalizing the property tree once per operator instead
        of once per visit is one of the larger wins on warm searches."""
        sig = self.__dict__.get("_signature")
        if sig is None:
            sig = (self.op_type, _canon(self.props))
            object.__setattr__(self, "_signature", sig)
        return sig

    def arity(self) -> int:
        if self.op_type == SOURCE:
            return 0
        return _ARITY.get(self.op_type, 1)

    def __repr__(self) -> str:
        return f"{self.op_type}({self.id})"


@dataclass(frozen=True)
class Link:
    src: str
    dst: str
    dst_port: int = 0

    def key(self) -> Tuple[str, str, int]:
        return (self.src, self.dst, self.dst_port)


class DAGError(Exception):
    pass


class DataflowDAG:
    """Immutable-ish DAG of operators. Mutation helpers return new DAGs."""

    def __init__(self, ops: Iterable[Operator] = (), links: Iterable[Link] = ()):
        self.ops: Dict[str, Operator] = {}
        for op in ops:
            if op.id in self.ops:
                raise DAGError(f"duplicate op id {op.id}")
            self.ops[op.id] = op
        self.links: List[Link] = list(links)
        self._rebuild_index()

    # -- construction --------------------------------------------------------
    def _rebuild_index(self) -> None:
        # every mutation helper ends here: drop the structural memos
        self._signature: Optional[Tuple] = None
        self._content_digest: Optional[str] = None
        self.in_links: Dict[str, List[Link]] = {i: [] for i in self.ops}
        self.out_links: Dict[str, List[Link]] = {i: [] for i in self.ops}
        seen = set()
        for l in self.links:
            if l.src not in self.ops or l.dst not in self.ops:
                raise DAGError(f"dangling link {l}")
            if (l.dst, l.dst_port) in seen:
                raise DAGError(f"duplicate input port {(l.dst, l.dst_port)}")
            seen.add((l.dst, l.dst_port))
            self.in_links[l.dst].append(l)
            self.out_links[l.src].append(l)
        for i in self.in_links:
            self.in_links[i].sort(key=lambda l: l.dst_port)

    def copy(self) -> "DataflowDAG":
        return DataflowDAG(self.ops.values(), self.links)

    def add_op(self, op: Operator) -> "DataflowDAG":
        d = self.copy()
        if op.id in d.ops:
            raise DAGError(f"op {op.id} exists")
        d.ops[op.id] = op
        d._rebuild_index()
        return d

    def remove_op(self, op_id: str) -> "DataflowDAG":
        d = self.copy()
        if op_id not in d.ops:
            raise DAGError(f"op {op_id} missing")
        del d.ops[op_id]
        d.links = [l for l in d.links if l.src != op_id and l.dst != op_id]
        d._rebuild_index()
        return d

    def replace_op(self, op: Operator) -> "DataflowDAG":
        d = self.copy()
        if op.id not in d.ops:
            raise DAGError(f"op {op.id} missing")
        d.ops[op.id] = op
        d._rebuild_index()
        return d

    def add_link(self, link: Link) -> "DataflowDAG":
        d = self.copy()
        d.links = d.links + [link]
        d._rebuild_index()
        return d

    def remove_link(self, link: Link) -> "DataflowDAG":
        d = self.copy()
        before = len(d.links)
        d.links = [l for l in d.links if l.key() != link.key()]
        if len(d.links) == before:
            raise DAGError(f"link {link} missing")
        d._rebuild_index()
        return d

    # -- queries ---------------------------------------------------------------
    def upstream(self, op_id: str) -> List[str]:
        return [l.src for l in self.in_links.get(op_id, [])]

    def downstream(self, op_id: str) -> List[str]:
        return [l.dst for l in self.out_links.get(op_id, [])]

    @property
    def sources(self) -> List[str]:
        return [i for i, op in self.ops.items() if not self.in_links.get(i)]

    @property
    def sinks(self) -> List[str]:
        return [i for i in self.ops if not self.out_links.get(i)]

    def topo_order(self) -> List[str]:
        indeg = {i: len(self.in_links.get(i, [])) for i in self.ops}
        stack = sorted([i for i, d in indeg.items() if d == 0])
        out: List[str] = []
        while stack:
            n = stack.pop(0)
            out.append(n)
            for l in self.out_links.get(n, []):
                indeg[l.dst] -= 1
                if indeg[l.dst] == 0:
                    stack.append(l.dst)
            stack.sort()
        if len(out) != len(self.ops):
            raise DAGError("cycle detected")
        return out

    def validate(self) -> None:
        self.topo_order()  # acyclic
        for i, op in self.ops.items():
            n_in = len(self.in_links.get(i, []))
            want = op.arity()
            if op.op_type == SOURCE and n_in != 0:
                raise DAGError(f"source {i} has inputs")
            if op.op_type != SOURCE and n_in != want:
                raise DAGError(
                    f"{op} expects {want} inputs, has {n_in}"
                )
            ports = [l.dst_port for l in self.in_links.get(i, [])]
            if ports != list(range(len(ports))):
                raise DAGError(f"{op} ports not contiguous: {ports}")

    def induced(self, op_ids: Set[str]) -> "DataflowDAG":
        ops = [self.ops[i] for i in op_ids]
        links = [l for l in self.links if l.src in op_ids and l.dst in op_ids]
        d = DataflowDAG.__new__(DataflowDAG)
        d.ops = {o.id: o for o in ops}
        d.links = links
        d._rebuild_index()
        return d

    def is_connected(self, op_ids: Set[str]) -> bool:
        """Weak connectivity of the induced subgraph."""
        if not op_ids:
            return True
        adj: Dict[str, Set[str]] = {i: set() for i in op_ids}
        for l in self.links:
            if l.src in op_ids and l.dst in op_ids:
                adj[l.src].add(l.dst)
                adj[l.dst].add(l.src)
        seen = set()
        stack = [next(iter(op_ids))]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(adj[n] - seen)
        return seen == set(op_ids)

    def ancestors(self, op_id: str) -> Set[str]:
        out: Set[str] = set()
        stack = list(self.upstream(op_id))
        while stack:
            n = stack.pop()
            if n in out:
                continue
            out.add(n)
            stack.extend(self.upstream(n))
        return out

    def signature(self) -> Tuple:
        """Whole-DAG structural signature (isomorphism-sensitive but id-free
        only for ops with unique signatures; used as a cheap memo key).
        Memoized — safe because every mutation helper rebuilds the index,
        which drops the memo."""
        sig = self._signature
        if sig is None:
            sig = (
                tuple(sorted(op.signature() + (op.id,) for op in self.ops.values())),
                tuple(sorted(l.key() for l in self.links)),
            )
            self._signature = sig
        return sig

    def content_digest(self) -> str:
        """Memoized sha256 of the structural signature (the same formula as
        the reference package, so a DAG carried across has the same digest)."""
        d = self._content_digest
        if d is None:
            d = hashlib.sha256(repr(self.signature()).encode()).hexdigest()
            self._content_digest = d
        return d

    def __repr__(self) -> str:
        return f"DAG(ops={len(self.ops)}, links={len(self.links)})"


# ---------------------------------------------------------------------------
# Schema inference (feeds §7.4 symbolic summaries + the engine)
# ---------------------------------------------------------------------------


def infer_schema(
    dag: DataflowDAG, source_schemas: Mapping[str, Sequence[str]]
) -> Dict[str, List[str]]:
    """Output column list per operator. Source schemas come from properties
    (``schema=[...]``) or the explicit mapping."""
    out: Dict[str, List[str]] = {}
    for op_id in dag.topo_order():
        op = dag.ops[op_id]
        ins = [out[l.src] for l in dag.in_links.get(op_id, [])]
        out[op_id] = _op_schema(op, ins, source_schemas)
    return out


def _op_schema(
    op: Operator, ins: List[List[str]], source_schemas: Mapping[str, Sequence[str]]
) -> List[str]:
    t = op.op_type
    if t == SOURCE:
        sch = op.get("schema") or source_schemas.get(op.id)
        if sch is None:
            raise DAGError(f"no schema for source {op.id}")
        return list(sch)
    if t in (FILTER, SORT, LIMIT, DISTINCT, REPLICATE, SINK):
        return list(ins[0])
    if t == PROJECT:
        return [name for name, _ in op.get("cols")]
    if t == JOIN:
        left, right = ins
        merged = list(left)
        for c in right:
            merged.append(c if c not in merged else f"r_{c}")
        return merged
    if t == UNION:
        return list(ins[0])
    if t == AGGREGATE:
        return list(op.get("group_by", ())) + [o for _, _, o in op.get("aggs")]
    if t == UNNEST:
        return list(ins[0]) + [op.get("out")]
    if t in (DICT_MATCHER, CLASSIFIER, SENTIMENT):
        return list(ins[0]) + [op.get("out")]
    if t == UDF:
        out_schema = op.get("out_schema")
        if out_schema is not None:
            return list(out_schema)
        adds = op.get("adds", ())
        return list(ins[0]) + list(adds)
    if t in (TRAIN_STEP, SERVE_STEP):
        return list(op.get("out_schema", ("metrics",)))
    if t == TOKENIZE:
        return ["tokens", "doc_id"]
    raise DAGError(f"no schema rule for {t}")
