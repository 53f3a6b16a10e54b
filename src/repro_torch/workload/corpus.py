"""Labeled-window corpus harvested from replayed certificates.

Every decided pair's ``Certificate`` pins a decomposition into windows,
each with a rename-invariant fingerprint, the EV that decided it, and its
verdict.  That is precisely the training row a GEqO-style learned verdict
scorer needs (PAPERS.md, arXiv 2401.01280): *given a window's shape, which
EV will accept it and what will it say?*  The replay driver's
``--dump-windows out.jsonl`` option streams one ``WindowExample`` per
certificate window record; this module defines the schema and the
round-tripping (``tests/test_torch_workload.py`` locks it).
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, TextIO

from repro_torch.api.certificate import Certificate

_VERDICT_CODE = {True: "T", False: "F", None: "U"}
_CODE_VERDICT = {"T": True, "F": False, "U": None}


@dataclass(frozen=True)
class WindowExample:
    """One labeled window: shape features on the left, EV verdict on the
    right.  ``fingerprint`` is the window's canonical rename-invariant hash
    (join key for dedup across sessions); ``op_hist`` counts operator types
    over the window's P side; ``topology`` summarizes the change shape the
    window covers (op/link counts of both sides, unit count)."""

    # provenance
    workload: str                   # W1..W8 shape of the originating session
    session_id: str
    pair_index: int
    family: str                     # edit family that produced the pair
    expected: str                   # the pair's oracle label ("eq"/"any")
    # the window itself
    record_kind: str                # "ev" | "identical" | "symbolic" | "search"
    cert_kind: str                  # EXACT/DECOMPOSITION/WITNESS/SYMBOLIC/-
    verdict: Optional[bool]         # the window's EV verdict (the label)
    ev_name: Optional[str] = None
    fingerprint: Optional[str] = None
    units: tuple = ()
    op_hist: Dict[str, int] = field(default_factory=dict)
    topology: Dict[str, int] = field(default_factory=dict)
    # EVs consulted for this window, in attempt order (search-harvested
    # examples only — certificates record just the deciding EV).  Trains the
    # per-EV attempt-ordering scorers: every non-final attempt was a miss.
    ev_attempts: tuple = ()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "workload": self.workload,
            "session_id": self.session_id,
            "pair_index": self.pair_index,
            "family": self.family,
            "expected": self.expected,
            "record_kind": self.record_kind,
            "cert_kind": self.cert_kind,
            "verdict": _VERDICT_CODE[self.verdict],
            "ev_name": self.ev_name,
            "fingerprint": self.fingerprint,
            "units": list(self.units),
            "op_hist": dict(sorted(self.op_hist.items())),
            "topology": dict(sorted(self.topology.items())),
            "ev_attempts": list(self.ev_attempts),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "WindowExample":
        return WindowExample(
            workload=d["workload"],
            session_id=d["session_id"],
            pair_index=d["pair_index"],
            family=d["family"],
            expected=d["expected"],
            record_kind=d["record_kind"],
            cert_kind=d["cert_kind"],
            verdict=_CODE_VERDICT[d["verdict"]],
            ev_name=d.get("ev_name"),
            fingerprint=d.get("fingerprint"),
            units=tuple(d.get("units", ())),
            op_hist=dict(d.get("op_hist", {})),
            topology=dict(d.get("topology", {})),
            ev_attempts=tuple(d.get("ev_attempts", ())),
        )


def _payload_sides(record_kind: str, payload: Dict[str, Any]):
    """(p_ops, q_ops, p_links, q_links) as raw serialized lists."""
    if record_kind == "identical":
        return (
            payload.get("p_ops", []),
            payload.get("q_ops", []),
            payload.get("p_links", []),
            payload.get("q_links", []),
        )
    # "ev" and "symbolic" payloads are (query) pairs of whole DAG dicts
    p, q = payload.get("P", {}), payload.get("Q", {})
    return (
        p.get("ops", []),
        q.get("ops", []),
        p.get("links", []),
        q.get("links", []),
    )


def windows_from_certificate(
    cert: Certificate,
    *,
    workload: str,
    session_id: str,
    pair_index: int,
    family: str,
    expected: str,
) -> List[WindowExample]:
    """One ``WindowExample`` per window record of a decided pair's
    certificate, features extracted from the record's own serialized
    payload (no access to the original DAGs needed)."""
    out: List[WindowExample] = []
    for rec in cert.windows:
        p_ops, q_ops, p_links, q_links = _payload_sides(rec.kind, rec.payload)
        hist = Counter(o.get("type", "?") for o in p_ops)
        out.append(
            WindowExample(
                workload=workload,
                session_id=session_id,
                pair_index=pair_index,
                family=family,
                expected=expected,
                record_kind=rec.kind,
                cert_kind=cert.kind,
                verdict=rec.verdict,
                ev_name=rec.ev_name,
                fingerprint=rec.fingerprint,
                units=tuple(rec.units),
                op_hist=dict(hist),
                topology={
                    "n_units": len(rec.units),
                    "p_ops": len(p_ops),
                    "q_ops": len(q_ops),
                    "p_links": len(p_links),
                    "q_links": len(q_links),
                },
            )
        )
    return out


def example_key(ex: WindowExample) -> str:
    """The dedup identity of an example: the rename-invariant fingerprint
    when the window has one (fingerprint equality implies identical shape
    features AND identical EV answers), else the canonical JSON of the
    shape+label fields (so fingerprint-less records still dedup exactly)."""
    if ex.fingerprint:
        return ex.fingerprint
    return json.dumps(
        [
            ex.record_kind,
            list(ex.units),
            dict(sorted(ex.op_hist.items())),
            dict(sorted(ex.topology.items())),
            _VERDICT_CODE[ex.verdict],
        ],
        sort_keys=True,
    )


@dataclass
class DumpReport:
    """What ``dump_windows`` wrote: counts by label plus duplicates dropped.

    Warm-cache sessions re-decide the same windows over and over; without
    fingerprint dedup those repeats dominate the corpus and a scorer
    trained on it mostly memorizes the duplicates."""

    written: int = 0
    dropped_duplicates: int = 0
    label_counts: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> str:
        labels = ", ".join(
            f"{k}={v}" for k, v in sorted(self.label_counts.items())
        )
        return (
            f"{self.written} examples ({labels or 'no labels'}), "
            f"{self.dropped_duplicates} duplicates dropped"
        )


def dedupe_windows(examples: Iterable[WindowExample]) -> List[WindowExample]:
    """First occurrence per ``example_key``, input order preserved."""
    seen: set = set()
    out: List[WindowExample] = []
    for ex in examples:
        k = example_key(ex)
        if k in seen:
            continue
        seen.add(k)
        out.append(ex)
    return out


def dump_windows(
    examples: Iterable[WindowExample], fh: TextIO, *, dedupe: bool = True
) -> DumpReport:
    """Write examples as JSON lines, deduplicated by fingerprint by default;
    returns a ``DumpReport`` with per-label counts."""
    report = DumpReport()
    seen: set = set()
    for ex in examples:
        if dedupe:
            k = example_key(ex)
            if k in seen:
                report.dropped_duplicates += 1
                continue
            seen.add(k)
        fh.write(json.dumps(ex.to_dict(), sort_keys=True))
        fh.write("\n")
        report.written += 1
        code = _VERDICT_CODE[ex.verdict]
        report.label_counts[code] = report.label_counts.get(code, 0) + 1
    return report


def load_windows(fh: TextIO) -> Iterator[WindowExample]:
    """Inverse of ``dump_windows`` (blank lines are skipped)."""
    for line in fh:
        line = line.strip()
        if line:
            yield WindowExample.from_dict(json.loads(line))
