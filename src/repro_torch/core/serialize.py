"""Tagged-JSON codec for DAGs, the port's copy of the reference package's
``api/serialize.py`` (the DAG part; query pairs come with the verifier).

Operator properties — predicates over exact rationals, nested tuples,
dicts — must come back as the same canonical objects, because
``Operator.signature()`` (and with it every content digest) hashes them.
JSON has none of those types, so every non-JSON value is wrapped in a
single-key ``{"!tag": payload}`` object:

    !frac   Fraction            [numerator, denominator]
    !tuple  tuple               [items...]
    !set    set/frozenset       [sorted items...]
    !dict   dict                [[key, value]...]   (keys may be non-strings)
    !lin    LinExpr             {"coeffs": [[col, frac]...], "const": frac}
    !cmp    LinCmp              {"expr": lin, "op": op}
    !streq  StrEq               [col, value, negated]
    !nl     NonLinearAtom       [fn, [cols...]]
    !pred   Pred                {"kind":..., "atom":..., "children": [...]}

Plain strings, numbers, bools, None and lists pass through untouched.  The
format is the reference package's, byte for byte, so a DAG encoded by one
package decodes in the other (``repro_torch.carry``).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Dict

from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq


class FormatError(ValueError):
    """Raised when a serialized DAG payload is malformed."""


# ---------------------------------------------------------------------------
# value codec
# ---------------------------------------------------------------------------


def encode_value(v: Any) -> Any:
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, Fraction):
        return {"!frac": [v.numerator, v.denominator]}
    if isinstance(v, tuple):
        return {"!tuple": [encode_value(x) for x in v]}
    if isinstance(v, list):
        return [encode_value(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return {"!set": sorted((encode_value(x) for x in v), key=repr)}
    if isinstance(v, dict):
        return {"!dict": [[encode_value(k), encode_value(x)] for k, x in sorted(v.items(), key=lambda kv: repr(kv[0]))]}
    if isinstance(v, LinExpr):
        return {
            "!lin": {
                "coeffs": [[c, encode_value(f)] for c, f in v.coeffs],
                "const": encode_value(v.const),
            }
        }
    if isinstance(v, LinCmp):
        return {"!cmp": {"expr": encode_value(v.expr), "op": v.op}}
    if isinstance(v, StrEq):
        return {"!streq": [v.col, v.value, v.negated]}
    if isinstance(v, NonLinearAtom):
        return {"!nl": [v.fn, list(v.cols)]}
    if isinstance(v, Pred):
        return {
            "!pred": {
                "kind": v.kind,
                "atom": encode_value(v.atom),
                "children": [encode_value(c) for c in v.children],
            }
        }
    raise FormatError(f"cannot serialize {type(v).__name__}: {v!r}")


def decode_value(v: Any) -> Any:
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    if not isinstance(v, dict) or len(v) != 1:
        raise FormatError(f"malformed encoded value: {v!r}")
    tag, payload = next(iter(v.items()))
    if tag == "!frac":
        return Fraction(payload[0], payload[1])
    if tag == "!tuple":
        return tuple(decode_value(x) for x in payload)
    if tag == "!set":
        return frozenset(decode_value(x) for x in payload)
    if tag == "!dict":
        return {decode_value(k): decode_value(x) for k, x in payload}
    if tag == "!lin":
        return LinExpr(
            tuple((c, decode_value(f)) for c, f in payload["coeffs"]),
            decode_value(payload["const"]),
        )
    if tag == "!cmp":
        return LinCmp(decode_value(payload["expr"]), payload["op"])
    if tag == "!streq":
        return StrEq(payload[0], payload[1], payload[2])
    if tag == "!nl":
        return NonLinearAtom(payload[0], tuple(payload[1]))
    if tag == "!pred":
        return Pred(
            payload["kind"],
            atom=decode_value(payload["atom"]),
            children=tuple(decode_value(c) for c in payload["children"]),
        )
    raise FormatError(f"unknown tag {tag!r}")


# ---------------------------------------------------------------------------
# operators and DAGs
# ---------------------------------------------------------------------------


def operator_to_dict(op: Operator) -> Dict[str, Any]:
    return {
        "id": op.id,
        "type": op.op_type,
        "props": [[k, encode_value(v)] for k, v in op.properties],
    }


def operator_from_dict(d: Dict[str, Any]) -> Operator:
    try:
        return Operator(
            d["id"],
            d["type"],
            tuple((k, decode_value(v)) for k, v in d["props"]),
        )
    except (KeyError, TypeError) as e:
        raise FormatError(f"malformed operator: {d!r}") from e


def dag_to_dict(dag: DataflowDAG) -> Dict[str, Any]:
    return {
        "ops": [operator_to_dict(op) for op in dag.ops.values()],
        "links": [[l.src, l.dst, l.dst_port] for l in dag.links],
    }


def dag_from_dict(d: Dict[str, Any]) -> DataflowDAG:
    try:
        return DataflowDAG(
            [operator_from_dict(o) for o in d["ops"]],
            [Link(s, t, p) for s, t, p in d["links"]],
        )
    except (KeyError, TypeError, ValueError) as e:
        raise FormatError(f"malformed DAG payload: {e}") from e
