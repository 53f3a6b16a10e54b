"""Exact linear-arithmetic decision procedure (Fourier-Motzkin elimination).

The paper's EVs push first-order formulas to an SMT solver (Z3), which is
complete for *linear* constraints (§6.1 / [8] in the paper).  No SMT solver is
installed offline, so we implement the linear-rational fragment ourselves:

  * ``satisfiable(atoms)``  — conjunction of LinCmp/StrEq atoms over Q.
  * ``implies(A, B)``       — A ⟹ B  via  unsat(A ∧ ¬B), DNF-expanded.
  * ``pred_equivalent``     — P ≡ Q  via implication both ways.

Fourier-Motzkin over rationals is sound and complete for conjunctions of
(strict/non-strict) linear inequalities; equalities are substituted out via
Gaussian pivoting first, which keeps the blow-up tame at workflow-predicate
sizes (a handful of columns).  String-equality atoms are decided separately
(conflicting literals / contradicting negations) — sound because string and
numeric domains are disjoint in our operator model.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.predicates import (
    Atom,
    LinCmp,
    LinExpr,
    NonLinearAtom,
    Pred,
    StrEq,
)


class UnsupportedAtomError(Exception):
    """Raised when a non-linear atom reaches the solver."""


# Internal constraint: (coeffs dict, const, strict) meaning  expr <= 0 / expr < 0
_Constraint = Tuple[Dict[str, Fraction], Fraction, bool]


def _to_constraints(atoms: Iterable[Atom]) -> Optional[List[_Constraint]]:
    """Lower atoms to <=/< constraints. Returns None if trivially unsat
    (string conflicts). Raises UnsupportedAtomError on non-linear atoms."""
    cons: List[_Constraint] = []
    str_eq: Dict[str, str] = {}
    str_ne: Dict[str, set] = {}
    disequalities: List[LinExpr] = []

    for a in atoms:
        if isinstance(a, NonLinearAtom):
            raise UnsupportedAtomError(repr(a))
        if isinstance(a, StrEq):
            if a.negated:
                str_ne.setdefault(a.col, set()).add(a.value)
            else:
                if a.col in str_eq and str_eq[a.col] != a.value:
                    return None
                str_eq[a.col] = a.value
            continue
        assert isinstance(a, LinCmp)
        d = dict(a.expr.coeffs)
        c = a.expr.const
        if a.op == "<=":
            cons.append((d, c, False))
        elif a.op == "<":
            cons.append((d, c, True))
        elif a.op == "==":
            cons.append((dict(d), c, False))
            cons.append(({k: -v for k, v in d.items()}, -c, False))
        elif a.op == "!=":
            disequalities.append(a.expr)
        else:
            raise AssertionError(a.op)

    for col, vals in str_ne.items():
        if col in str_eq and str_eq[col] in vals:
            return None

    # Disequalities over a dense order: expr != 0 cuts out a measure-zero set.
    # The conjunction is satisfiable iff the <=/< system has a solution not on
    # any of the hyperplanes. We handle them by case split: expr<0 OR expr>0.
    if disequalities:
        e = disequalities[0]
        rest = disequalities[1:]
        for branch in (LinCmp(e, "<"), LinCmp(e.scale(-1), "<")):
            sub = _to_constraints([branch] + [LinCmp(x, "!=") for x in rest])
            if sub is None:
                continue
            merged = cons + sub
            if _fm_satisfiable(merged):
                # signal satisfiable by returning a witness-compatible system
                return merged
        return None

    return cons


def _fm_satisfiable(cons: List[_Constraint]) -> bool:
    """Fourier-Motzkin elimination. True iff the system has a rational solution."""
    cons = [(dict(d), c, s) for d, c, s in cons]
    # collect variables
    while True:
        vars_ = sorted({v for d, _, _ in cons for v in d if d[v] != 0})
        if not vars_:
            break
        # eliminate the variable with the fewest pair combinations
        def cost(v: str) -> int:
            up = sum(1 for d, _, _ in cons if d.get(v, 0) > 0)
            lo = sum(1 for d, _, _ in cons if d.get(v, 0) < 0)
            return up * lo - up - lo

        x = min(vars_, key=cost)
        uppers: List[_Constraint] = []  # coeff > 0:  x <= (...)   (bound above)
        lowers: List[_Constraint] = []  # coeff < 0:  x >= (...)
        others: List[_Constraint] = []
        for d, c, s in cons:
            coef = d.get(x, Fraction(0))
            if coef > 0:
                uppers.append((d, c, s))
            elif coef < 0:
                lowers.append((d, c, s))
            else:
                d.pop(x, None)
                others.append((d, c, s))
        new = others
        for du, cu, su in uppers:
            for dl, cl, sl in lowers:
                a = du[x]
                b = -dl[x]
                # combine: b*(du) + a*(dl)  eliminates x
                d2: Dict[str, Fraction] = {}
                for k, v in du.items():
                    if k == x:
                        continue
                    d2[k] = d2.get(k, Fraction(0)) + b * v
                for k, v in dl.items():
                    if k == x:
                        continue
                    d2[k] = d2.get(k, Fraction(0)) + a * v
                d2 = {k: v for k, v in d2.items() if v != 0}
                c2 = b * cu + a * cl
                s2 = su or sl
                new.append((d2, c2, s2))
        cons = new
        # quick unsat check on constant rows
        for d, c, s in cons:
            if not d:
                if s and c >= 0:
                    return False
                if not s and c > 0:
                    return False
        cons = [(d, c, s) for d, c, s in cons if d]
        if len(cons) > 4000:
            # pathological blow-up guard: fall back to "maybe SAT" is NOT sound
            # for implication use; raise instead so callers report Unknown.
            raise UnsupportedAtomError("FM blow-up")
    for d, c, s in cons:
        if s and c >= 0:
            return False
        if not s and c > 0:
            return False
    return True


def satisfiable(atoms: Sequence[Atom]) -> bool:
    """Conjunction satisfiability over Q (+ disjoint string domain)."""
    cons = _to_constraints(atoms)
    if cons is None:
        return False
    return _fm_satisfiable(cons)


def implies(premise: Sequence[Atom], conclusion: Atom) -> bool:
    """premise ⟹ conclusion  (conjunction implies one atom)."""
    if isinstance(conclusion, StrEq):
        # decided syntactically: premise must contain the atom (or an equality
        # binding that forces it). Sound, conservatively incomplete.
        for a in premise:
            if isinstance(a, StrEq) and a == conclusion:
                return True
        # x == 'v' in premise and conclusion is x != 'w' (w != v)
        if conclusion.negated:
            for a in premise:
                if (
                    isinstance(a, StrEq)
                    and not a.negated
                    and a.col == conclusion.col
                    and a.value != conclusion.value
                ):
                    return True
        return not satisfiable(list(premise))  # vacuous truth
    if isinstance(conclusion, NonLinearAtom):
        return any(
            isinstance(a, NonLinearAtom) and a == conclusion for a in premise
        ) or not satisfiable(list(premise))
    neg = conclusion.negate()
    if neg.op == "!=":
        # premise ∧ (expr != 0) unsat for both strict branches
        return not satisfiable(list(premise) + [LinCmp(neg.expr, "!=")])
    return not satisfiable(list(premise) + [neg])


def conj_implies_conj(premise: Sequence[Atom], conclusion: Sequence[Atom]) -> bool:
    return all(implies(premise, c) for c in conclusion)


def pred_implies(p: Pred, q: Pred) -> bool:
    """P ⟹ Q for arbitrary boolean trees (DNF(P) each branch implies Q).

    Each DNF branch of P must imply at least one consistent covering of Q; we
    use the sound rule: branch ⟹ Q iff branch ∧ ¬Q is unsat, computed by
    DNF-expanding ¬Q as well.
    """
    notq = Pred.not_(q)
    for branch in p.dnf():
        if not satisfiable(branch):
            continue
        # branch ∧ ¬Q must be unsat: every DNF branch of ¬Q conflicts
        ok = True
        for nb in notq.dnf():
            if satisfiable(list(branch) + list(nb)):
                ok = False
                break
        if not ok:
            return False
    return True


def pred_equivalent(p: Pred, q: Pred) -> bool:
    return pred_implies(p, q) and pred_implies(q, p)


def pred_satisfiable(p: Pred) -> bool:
    return any(satisfiable(b) for b in p.dnf())
