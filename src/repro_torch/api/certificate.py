"""Replayable verification certificates (the auditable-equivalence layer).

Veer's soundness story (Lemma 4.1/5.3, Theorem 5.8) decomposes a version
pair into EV-verified windows — but a bare ``Optional[bool]`` forces the
caller to trust the search.  Following EqDAC's checkable explanations and
GEqO's verifier-as-filter, every verdict returned through ``repro_torch.api``
carries a ``Certificate``:

  * a **True** verdict records the chosen edit mapping and the covering
    decomposition, with one ``WindowRecord`` per window: its canonical
    ``fingerprint``, the deciding ``ev_name`` (or the structural-identity
    shortcut), the ``verdict``, and the window's serialized query pair;
  * a **False** verdict records its witness — the whole-pair window an
    inequivalence-capable EV refuted, or the §7.4 symbolic witness pair.

``Certificate.replay(registry)`` then re-checks every record against a
*fresh* EV resolved by name — no search, no verdict cache — so a True/False
produced hours ago by a warm cache is auditable today: tamper with any
record (fingerprint, verdict, window contents) and replay goes red.
Passing the version pair (``replay(registry, P, Q)``) additionally *binds*
the certificate: the pair digest must match, window fingerprints are
re-derived from the pair at the recorded unit sets, and the decomposition
must cover every change — so truncated evidence or a certificate minted for
a different pair is rejected too.  ``to_json``/``from_json`` round-trip the
whole object, which is what makes cross-session cached verdicts evidence
rather than trust-me.

The JSON format and replay semantics are specified normatively in
``docs/CERTIFICATES.md`` (executed by the doc-smoke CI job); EV-name
resolution at replay time is covered in ``docs/EV_PLUGINS.md``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.api.registry import EVRegistry, default_registry
from repro_torch.core.serialize import (
    CertificateFormatError,
    dag_from_dict,
    dag_to_dict,
    ops_from_list,
    ops_to_list,
    query_pair_from_dict,
    query_pair_to_dict,
)
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.symbolic import quick_inequivalent
from repro_torch.core.verifier import VerificationEvidence
from repro_torch.core.window import VersionPair, identical_under_mapping


def pair_digest(P: DataflowDAG, Q: DataflowDAG, semantics: str) -> str:
    """Content digest of a version pair — what binds a certificate to the
    specific ``(P, Q, semantics)`` it was issued for.  Built from the DAGs'
    memoized ``content_digest``s, so the service-layer hot path (the
    pair-verdict cache keys every submitted pair by this) costs one hash of
    two short hex strings after the first call per DAG."""
    blob = f"{P.content_digest()}|{Q.content_digest()}|{semantics}"
    return hashlib.sha256(blob.encode()).hexdigest()[:32]

# v2: pair_digest rebuilt on DataflowDAG.content_digest (the memoized
# per-DAG sha256) — digests from v1 certificates do not compare equal, so
# the version bump keeps old evidence from replaying under new rules
CERTIFICATE_FORMAT_VERSION = 2

# certificate kinds (mirror VerificationEvidence.kind)
EXACT = "exact"                    # no changes under the mapping
DECOMPOSITION = "decomposition"    # Lemma 5.3: every covering window verified
WITNESS = "witness"                # Theorem 5.8: whole-pair window refuted
SYMBOLIC = "symbolic"              # §7.4 symbolic inequivalence witness


@dataclass(frozen=True)
class WindowRecord:
    """One window of the certificate: ``(fingerprint, ev_name, verdict)``
    plus the serialized payload replay needs.

    ``kind == "ev"``: ``payload`` is the window's query pair; replay
    recomputes the fingerprint (tamper check), asks the registry for a fresh
    ``ev_name`` instance, and re-runs validate+check.
    ``kind == "identical"``: ``payload`` holds the mapped sub-graphs; replay
    re-runs the structural-identity check (no EV involved).
    ``kind == "symbolic"``: ``payload`` holds the whole witness pair; replay
    re-runs the §7.4 symbolic inequivalence check.
    """

    kind: str                      # "ev" | "identical" | "symbolic"
    verdict: Optional[bool]
    ev_name: Optional[str] = None
    fingerprint: Optional[str] = None
    units: Tuple[int, ...] = ()    # window's unit indices in the version pair
    payload: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "verdict": {True: "T", False: "F", None: "U"}[self.verdict],
            "ev_name": self.ev_name,
            "fingerprint": self.fingerprint,
            "units": list(self.units),
            "payload": self.payload,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "WindowRecord":
        try:
            return WindowRecord(
                kind=d["kind"],
                verdict={"T": True, "F": False, "U": None}[d["verdict"]],
                ev_name=d.get("ev_name"),
                fingerprint=d.get("fingerprint"),
                units=tuple(d.get("units", ())),
                payload=d.get("payload", {}),
            )
        except KeyError as e:
            raise CertificateFormatError(f"malformed window record: {e}") from e


@dataclass(frozen=True)
class ReplayFailure:
    index: int          # window record index (-1: certificate-level failure)
    reason: str

    def __str__(self) -> str:
        where = "certificate" if self.index < 0 else f"window {self.index}"
        return f"{where}: {self.reason}"


@dataclass(frozen=True)
class ReplayReport:
    ok: bool
    checked: int
    failures: Tuple[ReplayFailure, ...] = ()

    def __bool__(self) -> bool:
        return self.ok

    def summary(self) -> str:
        if self.ok:
            return f"replay OK ({self.checked} records re-checked)"
        return "replay FAILED: " + "; ".join(str(f) for f in self.failures)


@dataclass(frozen=True)
class Certificate:
    """Machine-replayable evidence behind one True/False verdict.

    Serialized layout and the rules a consumer may rely on are specified
    in ``docs/CERTIFICATES.md`` — the format is versioned
    (``CERTIFICATE_FORMAT_VERSION``) and incompatible changes bump it.
    """

    verdict: bool
    kind: str                                   # EXACT/DECOMPOSITION/WITNESS/SYMBOLIC
    semantics: str
    mapping: Tuple[Tuple[str, str], ...]        # the chosen edit mapping (P→Q)
    windows: Tuple[WindowRecord, ...]
    pair_digest: Optional[str] = None           # binds the cert to (P, Q, semantics)
    n_units: int = 0                            # unit count of the version pair
    version: int = CERTIFICATE_FORMAT_VERSION

    # -- replay --------------------------------------------------------------
    def replay(
        self,
        registry: Optional[EVRegistry] = None,
        P: Optional[DataflowDAG] = None,
        Q: Optional[DataflowDAG] = None,
    ) -> ReplayReport:
        """Independently re-check every record with fresh, uncached EVs.

        No search is repeated: the certificate pins the decomposition, so
        replay cost is one validate+check per EV-decided window.  Any
        mismatch — recomputed fingerprint, EV verdict, structural identity,
        wrong certificate shape — is reported, not raised.

        Passing the version pair ``P, Q`` upgrades the audit from
        *self-consistency* to *binding*: the pair digest must match (a
        certificate minted for a different pair is rejected), each window
        record's fingerprint is re-derived **from the pair** at the recorded
        unit set, and the decomposition must actually cover every change of
        the pair (truncated evidence is rejected).  Without ``P, Q`` only
        in-place record edits are catchable.
        """
        registry = registry if registry is not None else default_registry()
        failures: List[ReplayFailure] = []
        checked = 0

        if self.kind not in (EXACT, DECOMPOSITION, WITNESS, SYMBOLIC):
            return ReplayReport(False, 0, (ReplayFailure(-1, f"unknown kind {self.kind!r}"),))
        expected_verdict = self.kind in (EXACT, DECOMPOSITION)
        if self.verdict is not expected_verdict:
            failures.append(ReplayFailure(
                -1, f"kind {self.kind!r} cannot certify verdict {self.verdict}"
            ))

        if (P is None) != (Q is None):
            failures.append(ReplayFailure(-1, "pass both P and Q or neither"))
        elif P is not None and Q is not None:
            failures.extend(self._replay_binding(P, Q))

        if self.kind == SYMBOLIC:
            checked += 1
            failures.extend(self._replay_symbolic())
        else:
            if not self.windows:
                failures.append(ReplayFailure(-1, "certificate carries no windows"))
            # verdict entailment per kind: a True certificate needs every
            # window True (Lemma 5.3); a False one needs its single witness
            # window EV-refuted (Thm 5.8).  Without this, NEQ evidence
            # re-labeled as an EQ certificate would replay green.
            if self.kind in (EXACT, DECOMPOSITION):
                for i, rec in enumerate(self.windows):
                    if rec.verdict is not True:
                        failures.append(ReplayFailure(
                            i, f"{self.kind} certificate carries a "
                               f"non-True window verdict ({rec.verdict})"
                        ))
            elif self.kind == WITNESS:
                if (len(self.windows) != 1
                        or self.windows[0].kind != "ev"
                        or self.windows[0].verdict is not False):
                    failures.append(ReplayFailure(
                        -1, "witness certificate must carry exactly one "
                            "EV-refuted (False) window record"
                    ))
            for i, rec in enumerate(self.windows):
                checked += 1
                failures.extend(
                    ReplayFailure(i, r) for r in self._replay_record(rec, registry)
                )
        return ReplayReport(not failures, checked, tuple(failures))

    def _replay_binding(self, P: DataflowDAG, Q: DataflowDAG) -> List[ReplayFailure]:
        """Bind the certificate to a concrete version pair: digest, window
        fingerprints re-derived from the pair, and change coverage."""
        out: List[ReplayFailure] = []
        digest = pair_digest(P, Q, self.semantics)
        if self.pair_digest != digest:
            return [ReplayFailure(
                -1,
                f"certificate was issued for a different pair "
                f"(digest {self.pair_digest!r} != {digest!r})",
            )]
        try:
            vp = VersionPair(P, Q, EditMapping(self.mapping), self.semantics)
        except Exception as e:  # bad mapping / invalid DAGs
            return [ReplayFailure(-1, f"recorded mapping does not fit the pair: {e}")]
        if self.kind == EXACT:
            if vp.changes:
                out.append(ReplayFailure(
                    -1, "exact-match certificate but the pair has changes"
                ))
            return out
        if self.kind == SYMBOLIC:
            return out  # digest match suffices: the witness IS the whole pair
        all_units = frozenset(range(len(vp.units)))
        for i, rec in enumerate(self.windows):
            win = frozenset(rec.units)
            if not win <= all_units:
                out.append(ReplayFailure(i, "window units outside the pair"))
                continue
            if rec.kind == "ev":
                fp = vp.window_fingerprint(win)
                if fp != rec.fingerprint:
                    out.append(ReplayFailure(
                        i, "recorded window does not match the pair at its units"
                    ))
            elif rec.kind == "identical":
                # re-derive EVERYTHING from the pair — the payload is
                # attacker-controlled, so the pair itself must attest that
                # this window really is identical under the mapping
                p_ops = {p: vp.P.ops[p] for p in vp.p_ops(win)}
                q_ops = {q: vp.Q.ops[q] for q in vp.q_ops(win)}
                p_links = [
                    (l.src, l.dst, l.dst_port)
                    for l in vp.P.links if l.dst in p_ops
                ]
                q_links = [
                    (l.src, l.dst, l.dst_port)
                    for l in vp.Q.links if l.dst in q_ops
                ]
                if not p_ops or not identical_under_mapping(
                    p_ops, q_ops, p_links, q_links, vp.mapping.forward
                ):
                    out.append(ReplayFailure(
                        i, "pair's sub-graphs at the recorded units are not "
                           "identical under the mapping"
                    ))
        if self.kind == WITNESS:
            if not (len(self.windows) == 1
                    and frozenset(self.windows[0].units) == all_units):
                out.append(ReplayFailure(
                    -1, "witness window does not span the entire pair"
                ))
            return out
        # DECOMPOSITION: recorded windows must cover every change (Lemma 5.3)
        windows = [frozenset(r.units) for r in self.windows]
        for c in vp.changes:
            if not any(c.required_units <= w for w in windows):
                out.append(ReplayFailure(
                    -1, f"change {c.label!r} is not covered by any recorded window"
                ))
        return out

    def _replay_symbolic(self) -> List[ReplayFailure]:
        if not self.windows:
            return [ReplayFailure(-1, "symbolic certificate carries no witness pair")]
        rec = self.windows[0]
        if rec.kind != "symbolic" or rec.verdict is not False or self.verdict is not False:
            return [ReplayFailure(0, "symbolic witness must certify False")]
        try:
            P = dag_from_dict(rec.payload["P"])
            Q = dag_from_dict(rec.payload["Q"])
            sink_pairs = [tuple(sp) for sp in rec.payload["sink_pairs"]]
        except (CertificateFormatError, KeyError, TypeError) as e:
            return [ReplayFailure(0, f"malformed symbolic payload: {e}")]
        if not quick_inequivalent(P, Q, sink_pairs, self.semantics):
            return [ReplayFailure(0, "symbolic witness no longer shows inequivalence")]
        return []

    def _replay_record(self, rec: WindowRecord, registry: EVRegistry) -> List[str]:
        if rec.kind == "identical":
            if rec.verdict is not True:
                return ["identical record must carry verdict True"]
            try:
                p_ops = ops_from_list(rec.payload["p_ops"])
                q_ops = ops_from_list(rec.payload["q_ops"])
                p_links = [tuple(l) for l in rec.payload["p_links"]]
                q_links = [tuple(l) for l in rec.payload["q_links"]]
                forward = dict(rec.payload["forward"])
            except (CertificateFormatError, KeyError, TypeError) as e:
                return [f"malformed identity payload: {e}"]
            if not p_ops or not q_ops:
                # identical_under_mapping is vacuously True on empty sets —
                # an empty record certifies nothing and must not replay green
                return ["identical record carries no operators"]
            if not identical_under_mapping(p_ops, q_ops, p_links, q_links, forward):
                return ["sub-graphs are not identical under the recorded mapping"]
            return []

        if rec.kind != "ev":
            return [f"unknown record kind {rec.kind!r}"]
        try:
            qp = query_pair_from_dict(rec.payload)
        except CertificateFormatError as e:
            return [f"malformed query pair: {e}"]
        out: List[str] = []
        if qp.fingerprint() != rec.fingerprint:
            out.append(
                f"fingerprint mismatch: recorded {rec.fingerprint!r}, "
                f"recomputed {qp.fingerprint()!r}"
            )
        if rec.ev_name is None:
            return out + ["ev record names no EV"]
        try:
            ev = registry.create(rec.ev_name)   # fresh, uncached
        except KeyError as e:
            return out + [str(e)]
        if qp.semantics not in ev.semantics or not ev.validate(qp):
            return out + [f"{rec.ev_name} no longer accepts the window"]
        got = ev.check(qp)
        if got is not rec.verdict:
            out.append(
                f"{rec.ev_name} replayed {got}, certificate says {rec.verdict}"
            )
        if rec.verdict is False and not ev.can_prove_inequivalence:
            out.append(f"{rec.ev_name} cannot soundly certify inequivalence")
        return out

    # -- introspection -------------------------------------------------------
    @property
    def ev_names(self) -> Tuple[str, ...]:
        return tuple(sorted({w.ev_name for w in self.windows if w.ev_name}))

    def summary(self) -> str:
        n_ev = sum(1 for w in self.windows if w.kind == "ev")
        n_id = sum(1 for w in self.windows if w.kind == "identical")
        return (
            f"Certificate({'EQ' if self.verdict else 'NEQ'}/{self.kind}, "
            f"{len(self.windows)} windows: {n_ev} ev-checked"
            + (f" via {','.join(self.ev_names)}" if n_ev else "")
            + f", {n_id} identical)"
        )

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "verdict": self.verdict,
            "kind": self.kind,
            "semantics": self.semantics,
            "mapping": [[p, q] for p, q in self.mapping],
            "pair_digest": self.pair_digest,
            "n_units": self.n_units,
            "windows": [w.to_dict() for w in self.windows],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Certificate":
        try:
            if d["version"] != CERTIFICATE_FORMAT_VERSION:
                raise CertificateFormatError(
                    f"unsupported certificate version {d['version']!r}"
                )
            return Certificate(
                verdict=bool(d["verdict"]),
                kind=d["kind"],
                semantics=d["semantics"],
                mapping=tuple((p, q) for p, q in d["mapping"]),
                windows=tuple(WindowRecord.from_dict(w) for w in d["windows"]),
                pair_digest=d.get("pair_digest"),
                n_units=d.get("n_units", 0),
                version=d["version"],
            )
        except (KeyError, TypeError) as e:
            raise CertificateFormatError(f"malformed certificate: {e}") from e

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Certificate":
        try:
            payload = json.loads(s)
        except json.JSONDecodeError as e:
            raise CertificateFormatError(f"not JSON: {e}") from e
        return Certificate.from_dict(payload)


def certificate_from_evidence(
    evidence: Optional[VerificationEvidence],
) -> Optional[Certificate]:
    """Serialize a verifier's ``VerificationEvidence`` into a ``Certificate``
    (None for Unknown verdicts or missing evidence)."""
    if evidence is None or evidence.verdict is None:
        return None
    windows: List[WindowRecord] = []
    if evidence.kind == SYMBOLIC:
        if evidence.P is None or evidence.Q is None:
            return None
        windows.append(
            WindowRecord(
                kind="symbolic",
                verdict=False,
                payload={
                    "P": dag_to_dict(evidence.P),
                    "Q": dag_to_dict(evidence.Q),
                    "sink_pairs": [[p, q] for p, q in evidence.sink_pairs],
                },
            )
        )
    else:
        for w in evidence.windows:
            if w.kind == "identical":
                pl = w.identity_payload or {}
                windows.append(
                    WindowRecord(
                        kind="identical",
                        verdict=w.verdict,
                        units=tuple(w.units),
                        payload={
                            "p_ops": ops_to_list(pl.get("p_ops", {})),
                            "q_ops": ops_to_list(pl.get("q_ops", {})),
                            "p_links": [list(l) for l in pl.get("p_links", [])],
                            "q_links": [list(l) for l in pl.get("q_links", [])],
                            "forward": dict(pl.get("forward", {})),
                        },
                    )
                )
            else:
                if w.query_pair is None:
                    return None  # cannot certify a window we cannot serialize
                windows.append(
                    WindowRecord(
                        kind="ev",
                        verdict=w.verdict,
                        ev_name=w.ev_name,
                        fingerprint=w.fingerprint,
                        units=tuple(w.units),
                        payload=query_pair_to_dict(w.query_pair),
                    )
                )
    digest = (
        pair_digest(evidence.P, evidence.Q, evidence.semantics)
        if evidence.P is not None and evidence.Q is not None
        else None
    )
    return Certificate(
        verdict=bool(evidence.verdict),
        kind=evidence.kind,
        semantics=evidence.semantics,
        mapping=evidence.mapping.p_to_q,
        windows=tuple(windows),
        pair_digest=digest,
        n_units=evidence.n_units,
    )


def tampered(cert: Certificate, index: int = 0) -> Certificate:
    """A copy of ``cert`` with one window record corrupted — test/teaching
    helper showing that replay catches modified evidence."""
    recs = list(cert.windows)
    rec = recs[index]
    if rec.kind == "ev" and rec.fingerprint is not None:
        bad = replace(rec, fingerprint="0" * len(rec.fingerprint))
    else:
        bad = replace(rec, verdict=not rec.verdict if rec.verdict is not None else True)
    recs[index] = bad
    return replace(cert, windows=tuple(recs))
