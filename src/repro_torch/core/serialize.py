"""Tagged-JSON codec for the objects certificates must round-trip, the
port's copy of the reference package's ``api/serialize.py``.

Certificates (``repro_torch.api.certificate``) must survive ``to_json`` /
``from_json`` with verdicts *and replayability* intact, and a DAG carried
from the reference package must keep its content digest.  Operator
properties — predicates over exact rationals, nested tuples,
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
format is the reference package's, byte for byte, so a DAG, a query pair or
a certificate encoded by one package decodes in the other
(``repro_torch.carry``).  ``dag_to_dict``/``dag_from_dict`` and
``query_pair_to_dict``/... build on the value codec for whole DAGs and EV
query pairs.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Dict, List

from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.ev.base import QueryPair
from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq


class CertificateFormatError(ValueError):
    """Raised when a serialized certificate/DAG payload is malformed."""


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
    raise CertificateFormatError(f"cannot serialize {type(v).__name__}: {v!r}")


def decode_value(v: Any) -> Any:
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    if not isinstance(v, dict) or len(v) != 1:
        raise CertificateFormatError(f"malformed encoded value: {v!r}")
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
    raise CertificateFormatError(f"unknown tag {tag!r}")


# ---------------------------------------------------------------------------
# operators, DAGs, query pairs
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
        raise CertificateFormatError(f"malformed operator: {d!r}") from e


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
        raise CertificateFormatError(f"malformed DAG payload: {e}") from e


def query_pair_to_dict(qp: QueryPair) -> Dict[str, Any]:
    return {
        "P": dag_to_dict(qp.P),
        "Q": dag_to_dict(qp.Q),
        "sink_pairs": [[p, q] for p, q in qp.sink_pairs],
        "semantics": qp.semantics,
        "at_version_sink": qp.at_version_sink,
    }


def query_pair_from_dict(d: Dict[str, Any]) -> QueryPair:
    try:
        return QueryPair(
            dag_from_dict(d["P"]),
            dag_from_dict(d["Q"]),
            tuple((p, q) for p, q in d["sink_pairs"]),
            semantics=d["semantics"],
            at_version_sink=d["at_version_sink"],
        )
    except (KeyError, TypeError) as e:
        raise CertificateFormatError(f"malformed query pair: {e}") from e


def ops_to_list(ops: Dict[str, Operator]) -> List[Dict[str, Any]]:
    return [operator_to_dict(op) for op in ops.values()]


def ops_from_list(items: List[Dict[str, Any]]) -> Dict[str, Operator]:
    out = {}
    for item in items:
        op = operator_from_dict(item)
        out[op.id] = op
    return out
