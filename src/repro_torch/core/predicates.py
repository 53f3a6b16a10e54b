"""Linear predicate AST used by operator properties.

The paper's EVs (Equitas/Spes) restrict predicates to *linear* conditions so the
underlying solver is complete (§4.2 R3, §6.1).  We model predicates as a small
boolean algebra over linear constraints with exact rational (Fraction)
arithmetic, plus opaque string-equality atoms (dictionary matching etc.).

This is the port's own copy of the reference package's
``core/predicates.py``: the ``repr`` and ``key`` forms must stay identical to
it, because plan caches key on ``repr(pred)`` and ``Operator.signature()``
hashes ``key()``, so content digests agree across the two packages.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple, Union

Number = Union[int, float, Fraction]


def _frac(x: Number) -> Fraction:
    if isinstance(x, Fraction):
        return x
    if isinstance(x, float):
        return Fraction(x).limit_denominator(10**9)
    return Fraction(x)


# ---------------------------------------------------------------------------
# Linear expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinExpr:
    """``sum(coeffs[c] * col(c)) + const`` with exact rational coefficients."""

    coeffs: Tuple[Tuple[str, Fraction], ...]  # sorted by column name, no zeros
    const: Fraction

    # -- constructors -------------------------------------------------------
    @staticmethod
    def make(coeffs: Mapping[str, Number], const: Number = 0) -> "LinExpr":
        items = tuple(
            sorted((c, _frac(v)) for c, v in coeffs.items() if _frac(v) != 0)
        )
        return LinExpr(items, _frac(const))

    @staticmethod
    def col(name: str) -> "LinExpr":
        return LinExpr.make({name: 1})

    @staticmethod
    def lit(value: Number) -> "LinExpr":
        return LinExpr.make({}, value)

    # -- algebra -------------------------------------------------------------
    def _as_dict(self) -> Dict[str, Fraction]:
        return dict(self.coeffs)

    def __add__(self, other: "LinExpr") -> "LinExpr":
        d = self._as_dict()
        for c, v in other.coeffs:
            d[c] = d.get(c, Fraction(0)) + v
        return LinExpr.make(d, self.const + other.const)

    def __sub__(self, other: "LinExpr") -> "LinExpr":
        return self + other.scale(-1)

    def scale(self, k: Number) -> "LinExpr":
        kf = _frac(k)
        return LinExpr.make({c: v * kf for c, v in self.coeffs}, self.const * kf)

    def substitute(self, bindings: Mapping[str, "LinExpr"]) -> "LinExpr":
        """Replace columns by expressions (used to inline Project renames)."""
        out = LinExpr.lit(self.const)
        for c, v in self.coeffs:
            repl = bindings.get(c)
            if repl is None:
                out = out + LinExpr.make({c: v})
            else:
                out = out + repl.scale(v)
        return out

    def rename(self, ren: Mapping[str, str]) -> "LinExpr":
        return LinExpr.make(
            {ren.get(c, c): v for c, v in self.coeffs}, self.const
        )

    @property
    def columns(self) -> FrozenSet[str]:
        return frozenset(c for c, _ in self.coeffs)

    def is_const(self) -> bool:
        return not self.coeffs

    def key(self) -> Tuple:
        return ("lin", self.coeffs, self.const)

    def __repr__(self) -> str:  # canonical & deterministic
        parts = [f"{v}*{c}" for c, v in self.coeffs]
        parts.append(str(self.const))
        return " + ".join(parts)


# ---------------------------------------------------------------------------
# Atomic constraints
# ---------------------------------------------------------------------------

_OPS = ("<=", "<", "==", "!=")


@dataclass(frozen=True)
class LinCmp:
    """``expr (op) 0`` — normalized linear comparison."""

    expr: LinExpr
    op: str  # one of _OPS

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"bad op {self.op}")

    @staticmethod
    def make(lhs: LinExpr, op: str, rhs: LinExpr) -> "LinCmp":
        e = lhs - rhs
        if op in ("<=", "<", "==", "!="):
            return LinCmp(e, op)
        if op == ">=":
            return LinCmp(e.scale(-1), "<=")
        if op == ">":
            return LinCmp(e.scale(-1), "<")
        raise ValueError(f"bad op {op}")

    def negate(self) -> "LinCmp":
        if self.op == "<=":
            return LinCmp(self.expr.scale(-1), "<")
        if self.op == "<":
            return LinCmp(self.expr.scale(-1), "<=")
        if self.op == "==":
            return LinCmp(self.expr, "!=")
        return LinCmp(self.expr, "==")

    @property
    def columns(self) -> FrozenSet[str]:
        return self.expr.columns

    def rename(self, ren: Mapping[str, str]) -> "LinCmp":
        return LinCmp(self.expr.rename(ren), self.op)

    def substitute(self, bindings: Mapping[str, LinExpr]) -> "LinCmp":
        return LinCmp(self.expr.substitute(bindings), self.op)

    def key(self) -> Tuple:
        # normalize direction/scale for == and != so `x==1` and `-x==-1` hash equal
        e = self.expr
        if self.op in ("==", "!=") and e.coeffs:
            lead = e.coeffs[0][1]
            if lead < 0:
                e = e.scale(-1)
        elif e.coeffs:
            # scale so leading coefficient magnitude is 1 (preserve sign for <=, <)
            lead = abs(e.coeffs[0][1])
            e = e.scale(Fraction(1, 1) / lead)
        return ("cmp", self.op, e.key())

    def __repr__(self) -> str:
        return f"({self.expr} {self.op} 0)"


@dataclass(frozen=True)
class StrEq:
    """Opaque atom ``col == "literal"`` (or != when negated)."""

    col: str
    value: str
    negated: bool = False

    def negate(self) -> "StrEq":
        return StrEq(self.col, self.value, not self.negated)

    @property
    def columns(self) -> FrozenSet[str]:
        return frozenset([self.col])

    def rename(self, ren: Mapping[str, str]) -> "StrEq":
        return StrEq(ren.get(self.col, self.col), self.value, self.negated)

    def substitute(self, bindings: Mapping[str, LinExpr]) -> "StrEq":
        if self.col in bindings:
            b = bindings[self.col]
            # only pure renames are substitutable for string columns
            if len(b.coeffs) == 1 and b.coeffs[0][1] == 1 and b.const == 0:
                return StrEq(b.coeffs[0][0], self.value, self.negated)
            raise NonLinearError(f"string column {self.col} bound to {b}")
        return self

    def key(self) -> Tuple:
        return ("streq", self.col, self.value, self.negated)

    def __repr__(self) -> str:
        op = "!=" if self.negated else "=="
        return f"({self.col} {op} {self.value!r})"


@dataclass(frozen=True)
class NonLinearAtom:
    """Marker for non-linear conditions (e.g. ``a*b < c``).

    EV restriction checks reject windows containing these (R3); the engine can
    still execute them via the attached python lambda name.
    """

    fn: str
    cols: Tuple[str, ...]

    @property
    def columns(self) -> FrozenSet[str]:
        return frozenset(self.cols)

    def negate(self) -> "NonLinearAtom":
        return NonLinearAtom("not_" + self.fn, self.cols)

    def rename(self, ren: Mapping[str, str]) -> "NonLinearAtom":
        return NonLinearAtom(self.fn, tuple(ren.get(c, c) for c in self.cols))

    def substitute(self, bindings: Mapping[str, LinExpr]) -> "NonLinearAtom":
        cols = []
        for c in self.cols:
            b = bindings.get(c)
            if b is None:
                cols.append(c)
            elif len(b.coeffs) == 1 and b.coeffs[0][1] == 1 and b.const == 0:
                cols.append(b.coeffs[0][0])
            else:
                raise NonLinearError(f"nonlinear atom col {c} bound to {b}")
        return NonLinearAtom(self.fn, tuple(cols))

    def key(self) -> Tuple:
        return ("nl", self.fn, self.cols)

    def __repr__(self) -> str:
        return f"{self.fn}({', '.join(self.cols)})"


Atom = Union[LinCmp, StrEq, NonLinearAtom]


class NonLinearError(Exception):
    pass


# ---------------------------------------------------------------------------
# Boolean combinations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pred:
    """Predicate = boolean tree. ``kind`` in {atom, and, or, not, true, false}."""

    kind: str
    atom: Optional[Atom] = None
    children: Tuple["Pred", ...] = ()

    # -- constructors -------------------------------------------------------
    @staticmethod
    def true() -> "Pred":
        return Pred("true")

    @staticmethod
    def false() -> "Pred":
        return Pred("false")

    @staticmethod
    def of(atom: Atom) -> "Pred":
        return Pred("atom", atom=atom)

    @staticmethod
    def and_(*ps: "Pred") -> "Pred":
        flat: List[Pred] = []
        for p in ps:
            if p.kind == "true":
                continue
            if p.kind == "false":
                return Pred.false()
            if p.kind == "and":
                flat.extend(p.children)
            else:
                flat.append(p)
        if not flat:
            return Pred.true()
        if len(flat) == 1:
            return flat[0]
        return Pred("and", children=tuple(flat))

    @staticmethod
    def or_(*ps: "Pred") -> "Pred":
        flat: List[Pred] = []
        for p in ps:
            if p.kind == "false":
                continue
            if p.kind == "true":
                return Pred.true()
            if p.kind == "or":
                flat.extend(p.children)
            else:
                flat.append(p)
        if not flat:
            return Pred.false()
        if len(flat) == 1:
            return flat[0]
        return Pred("or", children=tuple(flat))

    @staticmethod
    def not_(p: "Pred") -> "Pred":
        if p.kind == "true":
            return Pred.false()
        if p.kind == "false":
            return Pred.true()
        if p.kind == "not":
            return p.children[0]
        return Pred("not", children=(p,))

    # -- convenience builders ------------------------------------------------
    @staticmethod
    def cmp(col: str, op: str, value: Number) -> "Pred":
        return Pred.of(LinCmp.make(LinExpr.col(col), op, LinExpr.lit(value)))

    @staticmethod
    def col_cmp(lhs: str, op: str, rhs: str) -> "Pred":
        return Pred.of(LinCmp.make(LinExpr.col(lhs), op, LinExpr.col(rhs)))

    @staticmethod
    def str_eq(col: str, value: str) -> "Pred":
        return Pred.of(StrEq(col, value))

    # -- structure -----------------------------------------------------------
    @property
    def columns(self) -> FrozenSet[str]:
        if self.kind == "atom":
            return self.atom.columns
        out: FrozenSet[str] = frozenset()
        for c in self.children:
            out |= c.columns
        return out

    def is_linear(self) -> bool:
        if self.kind == "atom":
            return not isinstance(self.atom, NonLinearAtom)
        return all(c.is_linear() for c in self.children)

    def rename(self, ren: Mapping[str, str]) -> "Pred":
        if self.kind == "atom":
            return Pred.of(self.atom.rename(ren))
        if self.kind in ("true", "false"):
            return self
        return Pred(self.kind, children=tuple(c.rename(ren) for c in self.children))

    def substitute(self, bindings: Mapping[str, LinExpr]) -> "Pred":
        if self.kind == "atom":
            return Pred.of(self.atom.substitute(bindings))
        if self.kind in ("true", "false"):
            return self
        return Pred(
            self.kind, children=tuple(c.substitute(bindings) for c in self.children)
        )

    # -- normal forms ---------------------------------------------------------
    def nnf(self, negate: bool = False) -> "Pred":
        """Negation normal form (push NOT to atoms)."""
        if self.kind == "true":
            return Pred.false() if negate else self
        if self.kind == "false":
            return Pred.true() if negate else self
        if self.kind == "atom":
            return Pred.of(self.atom.negate()) if negate else self
        if self.kind == "not":
            return self.children[0].nnf(not negate)
        if self.kind == "and":
            ch = tuple(c.nnf(negate) for c in self.children)
            return Pred.or_(*ch) if negate else Pred.and_(*ch)
        if self.kind == "or":
            ch = tuple(c.nnf(negate) for c in self.children)
            return Pred.and_(*ch) if negate else Pred.or_(*ch)
        raise AssertionError(self.kind)

    def dnf(self) -> List[List[Atom]]:
        """Disjunctive normal form: list of conjunctions of atoms.

        ``[]`` means FALSE; ``[[]]`` means TRUE.
        """
        p = self.nnf()

        def go(q: Pred) -> List[List[Atom]]:
            if q.kind == "true":
                return [[]]
            if q.kind == "false":
                return []
            if q.kind == "atom":
                # expand disequalities a != 0  ->  a < 0 OR -a < 0 for solver use
                return [[q.atom]]
            if q.kind == "or":
                out: List[List[Atom]] = []
                for c in q.children:
                    out.extend(go(c))
                return out
            if q.kind == "and":
                prod: List[List[Atom]] = [[]]
                for c in q.children:
                    branches = go(c)
                    prod = [a + b for a, b in itertools.product(prod, branches)]
                    if not prod:
                        return []
                return prod
            raise AssertionError(q.kind)

        return go(p)

    def key(self) -> Tuple:
        if self.kind == "atom":
            return self.atom.key()
        if self.kind in ("true", "false"):
            return (self.kind,)
        child_keys = tuple(sorted(c.key() for c in self.children)) if self.kind in (
            "and",
            "or",
        ) else tuple(c.key() for c in self.children)
        return (self.kind,) + child_keys

    def __repr__(self) -> str:
        if self.kind == "true":
            return "TRUE"
        if self.kind == "false":
            return "FALSE"
        if self.kind == "atom":
            return repr(self.atom)
        if self.kind == "not":
            return f"NOT {self.children[0]!r}"
        joiner = " AND " if self.kind == "and" else " OR "
        return "(" + joiner.join(repr(c) for c in self.children) + ")"


TRUE = Pred.true()
FALSE = Pred.false()
