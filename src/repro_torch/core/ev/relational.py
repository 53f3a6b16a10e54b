"""Relational canonicalizer shared by the Equitas/Spes/UDP-style EVs.

Queries are normalized bottom-up into *SPJ blocks* separated by *spine nodes*
(Aggregate / LeftOuterJoin / Union), mirroring how the published EVs model
queries (U-expressions / symbolic representations that collapse SPJ algebra
and keep aggregation scopes explicit).

An SPJ block is
    atoms : multiset of aliased leaf references (symbolic inputs or spine nodes)
    pred  : predicate over alias-qualified columns (``a{i}.{col}``)
    proj  : ordered output (name, LinExpr over alias-qualified columns)

Bag-equivalence of SPJ blocks is decided by atom-bijection search +
Fourier-Motzkin predicate equivalence + canonical projection equality —
complete for conjunctive SPJ with linear comparisons under bag semantics
(Chaudhuri-Vardi isomorphism, lifted to comparison predicates).  Spine nodes
compare structurally with recursive block equivalence.  Canonicalization
includes the classic pushdowns so versions differing by
filter-past-{join,aggregate,outer-join} / project-past-filter / empty-project
rewrites reach the same form.

Supported fragment (format shared by all EVs; see docs/ARCHITECTURE.md —
this module is the decision procedure *behind* Equitas/Spes/UDP, so its
fragment is their union):

    ============== ==========================================================
    Module         relational (normalizer + block equivalence)
    Operators      Source, Filter, Project, Join(inner/left_outer),
                   Aggregate, Union, Replicate, Sink
    Semantics      bag (set/ordered handled by the calling EV's policy)
    Restrictions   linear predicates; anything else raises ``UnsupportedOp``
    Monotonic      n/a — validity policy lives in the EVs, not here
    Proves inequiv complete only for union-free SPJ blocks
    ============== ==========================================================
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.predicates import LinCmp, LinExpr, Pred
from repro_torch.core.ev import solver


class UnsupportedOp(Exception):
    """Query contains an operator outside this normalizer's fragment."""


# ---------------------------------------------------------------------------
# Normal form
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Leaf:
    """Symbolic input table (window boundary / source)."""

    name: str
    schema: Tuple[str, ...]


@dataclass(frozen=True)
class AggNode:
    child: "Block"
    group_by: Tuple[str, ...]          # output column names (= input names)
    aggs: Tuple[Tuple[str, object, str], ...]  # (fn, LinExpr-over-child-out|"*", out)
    schema: Tuple[str, ...]


@dataclass(frozen=True)
class LOJNode:
    left: "Block"
    right: "Block"
    cond: Pred                          # over (left-out ∪ renamed right-out) names
    schema: Tuple[str, ...]


@dataclass(frozen=True)
class UnionNode:
    children: Tuple["Block", ...]       # flattened bag union
    schema: Tuple[str, ...]


Ref = Union[Leaf, AggNode, LOJNode, UnionNode]


@dataclass(frozen=True)
class Block:
    atoms: Tuple[Tuple[Ref, int], ...]  # (ref, alias-id) alias unique in block
    pred: Pred                          # over alias-qualified columns
    proj: Tuple[Tuple[str, LinExpr], ...]

    @property
    def schema(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.proj)

    def bindings(self) -> Dict[str, LinExpr]:
        return {n: e for n, e in self.proj}


def _qual(alias: int, col: str) -> str:
    return f"a{alias}.{col}"


def _identity_block(ref: Ref, alias: int = 0) -> Block:
    return Block(
        atoms=((ref, alias),),
        pred=Pred.true(),
        proj=tuple((c, LinExpr.col(_qual(alias, c))) for c in ref.schema),
    )


def _shift_aliases(b: Block, offset: int) -> Block:
    if offset == 0:
        return b
    ren: Dict[str, str] = {}
    atoms = []
    for ref, a in b.atoms:
        for c in ref.schema:
            ren[_qual(a, c)] = _qual(a + offset, c)
        atoms.append((ref, a + offset))
    return Block(
        atoms=tuple(atoms),
        pred=b.pred.rename(ren),
        proj=tuple((n, e.rename(ren)) for n, e in b.proj),
    )


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

SPJ_TYPES = frozenset({D.SOURCE, D.FILTER, D.PROJECT, D.JOIN, D.REPLICATE, D.SINK})
SPINE_TYPES = frozenset({D.AGGREGATE, D.UNION})  # + left_outer joins


def normalize(dag: DataflowDAG, sink_id: str, *, allow_union: bool = True) -> Block:
    """Normal form of the query rooted at ``sink_id``."""
    memo: Dict[str, Block] = {}

    def go(op_id: str) -> Block:
        if op_id in memo:
            return memo[op_id]
        op = dag.ops[op_id]
        ins = [l.src for l in dag.in_links.get(op_id, [])]
        out = _normalize_op(dag, op, [go(i) for i in ins], allow_union=allow_union)
        memo[op_id] = out
        return out

    return go(sink_id)


def _normalize_op(
    dag: DataflowDAG, op, child_blocks: List[Block], *, allow_union: bool
) -> Block:
    t = op.op_type
    if t == D.SOURCE:
        schema = op.get("schema")
        if schema is None:
            raise UnsupportedOp(f"source {op.id} without schema")
        return _identity_block(Leaf(op.id, tuple(schema)))

    if t in (D.REPLICATE, D.SINK):
        return child_blocks[0]

    if t == D.FILTER:
        b = child_blocks[0]
        pred: Pred = op.get("pred")
        if not pred.is_linear():
            raise UnsupportedOp("non-linear predicate")
        return _apply_filter(b, pred)

    if t == D.PROJECT:
        b = child_blocks[0]
        bind = b.bindings()
        proj = []
        for name, expr in op.get("cols"):
            if isinstance(expr, str):
                e = bind.get(expr)
                if e is None:
                    raise UnsupportedOp(f"project of unknown column {expr}")
            else:
                e = expr.substitute(bind)
            proj.append((name, e))
        return Block(b.atoms, b.pred, tuple(proj))

    if t == D.JOIN:
        how = op.get("how", "inner")
        left, right = child_blocks
        if how == "inner":
            return _merge_join(left, right, op.get("on"))
        if how == "left_outer":
            # spine node; cond over left-out + renamed right-out names
            lnames = [n for n, _ in left.proj]
            rnames = [n for n, _ in right.proj]
            ren = {c: f"r_{c}" for c in rnames if c in lnames}
            schema = tuple(lnames + [ren.get(c, c) for c in rnames])
            cond = Pred.and_(
                *[
                    Pred.of(
                        LinCmp.make(
                            LinExpr.col(lc), "==", LinExpr.col(ren.get(rc, rc))
                        )
                    )
                    for lc, rc in op.get("on")
                ]
            )
            node = LOJNode(left, right, cond, schema)
            return _identity_block(node)
        raise UnsupportedOp(f"join how={how}")

    if t == D.AGGREGATE:
        b = child_blocks[0]
        bind = b.bindings()
        group_by = tuple(op.get("group_by", ()))
        aggs = []
        for fn, col, outn in op.get("aggs"):
            if fn not in ("count", "sum", "min", "max", "avg"):
                raise UnsupportedOp(f"agg fn {fn}")
            if col == "*":
                aggs.append((fn, "*", outn))
            else:
                if col not in bind:
                    raise UnsupportedOp(f"agg over unknown column {col}")
                # canonical input expr over child OUTPUT names (see compare)
                aggs.append((fn, LinExpr.col(col), outn))
        for g in group_by:
            if g not in bind:
                raise UnsupportedOp(f"group_by unknown column {g}")
        schema = group_by + tuple(o for _, _, o in aggs)
        node = AggNode(b, group_by, tuple(aggs), schema)
        return _identity_block(node)

    if t == D.UNION:
        if not allow_union:
            raise UnsupportedOp("union")
        l, r = child_blocks
        children: List[Block] = []
        for side in (l, r):
            # flatten nested unions when the block is a bare UnionNode
            if (
                len(side.atoms) == 1
                and isinstance(side.atoms[0][0], UnionNode)
                and _is_identity(side)
            ):
                children.extend(side.atoms[0][0].children)
            else:
                children.append(side)
        schema = children[0].schema
        for c in children[1:]:
            if c.schema != schema:
                raise UnsupportedOp("union schema mismatch")
        node = UnionNode(tuple(children), schema)
        return _identity_block(node)

    raise UnsupportedOp(t)


def _is_identity(b: Block) -> bool:
    ref, a = b.atoms[0]
    if b.pred.kind != "true":
        return False
    want = tuple((c, LinExpr.col(_qual(a, c))) for c in ref.schema)
    return b.proj == want


def _apply_filter(b: Block, pred: Pred) -> Block:
    """Filter over a block's output; push conjuncts into single-atom spine
    children where the classic rewrites allow (canonical deepest position)."""
    conjuncts = list(pred.children) if pred.kind == "and" else [pred]
    remaining: List[Pred] = []
    atoms = list(b.atoms)
    for c in conjuncts:
        # the filter predicate references the block's OUTPUT column names
        pushed = False
        if len(atoms) == 1 and _is_identity(b):
            ref, alias = atoms[0]
            cols = set(c.columns)
            if isinstance(ref, AggNode) and cols and cols <= set(ref.group_by):
                # σ_g(γ(X)) ≡ γ(σ_g(X)) — push through the aggregate
                inner = c.substitute(ref.child.bindings())
                new_child = Block(
                    ref.child.atoms,
                    Pred.and_(ref.child.pred, inner),
                    ref.child.proj,
                )
                ref = AggNode(new_child, ref.group_by, ref.aggs, ref.schema)
                atoms[0] = (ref, alias)
                b = _identity_block(ref, alias)
                pushed = True
            elif isinstance(ref, LOJNode) and cols and cols <= set(
                n for n, _ in ref.left.proj
            ):
                # σ_L(A ⟕ B) ≡ (σ_L A) ⟕ B
                inner = c.substitute(ref.left.bindings())
                new_left = Block(
                    ref.left.atoms,
                    Pred.and_(ref.left.pred, inner),
                    ref.left.proj,
                )
                ref = LOJNode(new_left, ref.right, ref.cond, ref.schema)
                atoms[0] = (ref, alias)
                b = _identity_block(ref, alias)
                pushed = True
            elif isinstance(ref, UnionNode) and cols:
                # σ(A ∪ B) ≡ σ(A) ∪ σ(B)
                new_children = []
                for ch in ref.children:
                    inner = c.substitute(ch.bindings())
                    new_children.append(
                        Block(ch.atoms, Pred.and_(ch.pred, inner), ch.proj)
                    )
                ref = UnionNode(tuple(new_children), ref.schema)
                atoms[0] = (ref, alias)
                b = _identity_block(ref, alias)
                pushed = True
        if not pushed:
            remaining.append(c)
    if not remaining:
        return b
    bind = b.bindings()
    inner = Pred.and_(*remaining).substitute(bind)
    return Block(tuple(atoms), Pred.and_(b.pred, inner), b.proj)


def _merge_join(left: Block, right: Block, on) -> Block:
    r = _shift_aliases(right, max((a for _, a in left.atoms), default=-1) + 1)
    lbind, rbind = left.bindings(), r.bindings()
    cond = Pred.true()
    for lc, rc in on:
        cond = Pred.and_(
            cond, Pred.of(LinCmp.make(lbind[lc], "==", rbind[rc]))
        )
    lnames = [n for n, _ in left.proj]
    proj = list(left.proj)
    for n, e in r.proj:
        proj.append((f"r_{n}" if n in lnames else n, e))
    return Block(
        left.atoms + r.atoms,
        Pred.and_(left.pred, r.pred, cond),
        tuple(proj),
    )


# ---------------------------------------------------------------------------
# Equivalence
# ---------------------------------------------------------------------------


class _Budget:
    def __init__(self, n: int = 20000):
        self.n = n

    def tick(self):
        self.n -= 1
        if self.n <= 0:
            raise UnsupportedOp("equivalence search budget exceeded")


def refs_equivalent(a: Ref, b: Ref, budget: Optional[_Budget] = None,
                    memo: Optional[dict] = None) -> bool:
    budget = budget or _Budget()
    memo = memo if memo is not None else {}
    key = (id(a), id(b))
    if key in memo:
        return memo[key]
    budget.tick()
    out: bool
    if isinstance(a, Leaf) and isinstance(b, Leaf):
        out = a == b
    elif isinstance(a, AggNode) and isinstance(b, AggNode):
        out = (
            a.group_by == b.group_by
            and len(a.aggs) == len(b.aggs)
            and all(
                fa == fb and oa == ob and _agg_in_eq(ea, eb)
                for (fa, ea, oa), (fb, eb, ob) in zip(a.aggs, b.aggs)
            )
            and blocks_equivalent(a.child, b.child, budget, memo)
        )
    elif isinstance(a, LOJNode) and isinstance(b, LOJNode):
        out = (
            a.schema == b.schema
            and solver.pred_equivalent(a.cond, b.cond)
            and blocks_equivalent(a.left, b.left, budget, memo)
            and blocks_equivalent(a.right, b.right, budget, memo)
        )
    elif isinstance(a, UnionNode) and isinstance(b, UnionNode):
        out = a.schema == b.schema and _multiset_match(
            list(a.children),
            list(b.children),
            lambda x, y: blocks_equivalent(x, y, budget, memo),
        )
    else:
        out = False
    memo[key] = out
    return out


def _agg_in_eq(ea, eb) -> bool:
    if ea == "*" or eb == "*":
        return ea == eb
    return ea == eb  # canonical LinExpr equality


def _multiset_match(xs: List, ys: List, eq) -> bool:
    if len(xs) != len(ys):
        return False
    if not xs:
        return True
    x = xs[0]
    for i, y in enumerate(ys):
        if eq(x, y) and _multiset_match(xs[1:], ys[:i] + ys[i + 1 :], eq):
            return True
    return False


def blocks_equivalent(
    A: Block, B: Block, budget: Optional[_Budget] = None, memo: Optional[dict] = None
) -> bool:
    """Bag-equivalence of SPJ blocks (complete for linear SPJ)."""
    budget = budget or _Budget()
    memo = memo if memo is not None else {}
    if A.schema != B.schema:
        return False
    try:
        a_sat = solver.pred_satisfiable(A.pred)
        b_sat = solver.pred_satisfiable(B.pred)
    except solver.UnsupportedAtomError:
        raise UnsupportedOp("predicate outside solver fragment")
    if not a_sat or not b_sat:
        return a_sat == b_sat  # both always-empty ⇒ equivalent
    if len(A.atoms) != len(B.atoms):
        return False

    # group B-atoms by compatibility with each A-atom (recursive equivalence)
    a_atoms, b_atoms = list(A.atoms), list(B.atoms)

    def compatible(i: int, j: int) -> bool:
        return refs_equivalent(a_atoms[i][0], b_atoms[j][0], budget, memo)

    n = len(a_atoms)
    used = [False] * n
    assign: List[int] = [0] * n

    def try_assign(i: int) -> bool:
        budget.tick()
        if i == n:
            return _check_assignment(A, B, assign)
        for j in range(n):
            if used[j]:
                continue
            if compatible(i, j):
                used[j] = True
                assign[i] = j
                if try_assign(i + 1):
                    return True
                used[j] = False
        return False

    return try_assign(0)


def _check_assignment(A: Block, B: Block, assign: List[int]) -> bool:
    """Under alias bijection σ (B→A order), preds equivalent & proj equal."""
    ren: Dict[str, str] = {}
    for i, j in enumerate(assign):
        a_ref, a_alias = A.atoms[i]
        b_ref, b_alias = B.atoms[j]
        for c in b_ref.schema:
            ren[_qual(b_alias, c)] = _qual(a_alias, c)
    b_pred = B.pred.rename(ren)
    b_proj = tuple((n, e.rename(ren)) for n, e in B.proj)
    if b_proj != A.proj:
        return False
    try:
        return solver.pred_equivalent(A.pred, b_pred)
    except solver.UnsupportedAtomError:
        return False


def query_equivalent(qa: Block, qb: Block) -> bool:
    return blocks_equivalent(qa, qb)


def is_spj_only(b: Block) -> bool:
    return all(isinstance(ref, Leaf) for ref, _ in b.atoms)
