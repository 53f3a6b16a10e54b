"""The port's certificates (``repro_torch.api.certificate``) against the
reference package's, on the CPU.

A certificate written by either package parses in the other and replays
green there, bound to the pair; a ``tampered`` copy fails replay in both;
the tagged-JSON codec writes the same bytes for the same query pairs and
operators.  Then the port's own replay contract, as
``tests/test_certificate.py`` holds the reference to it: round trips are
byte-stable, malformed payloads raise ``CertificateFormatError``, cache-hit
verdicts carry complete certificates, and forged or truncated evidence and
foreign pairs are refused.  The pairs are ``tests/test_torch_verifier.py``'s.
"""

import dataclasses
import json

import pytest

from repro import api as ref_api
from repro.api import serialize as ref_serialize
from repro.core import dag as D
from repro.core.edits import identity_mapping as ref_identity_mapping
from repro.core.window import VersionPair as RefVersionPair

from repro_torch import api as port_api
from repro_torch.api import Certificate, CertificateFormatError, WindowRecord, pair_digest, tampered
from repro_torch.api import serialize
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.edits import identity_mapping
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.predicates import Pred
from repro_torch.core.window import VersionPair, identical_under_mapping

from test_torch_verifier import NAMES, carried, run_pair

op = Operator.make
SCHEMA = ("a", "b", "c")
CFG = port_api.VeerConfig(evs=("equitas", "spes", "udp"))


@pytest.mark.parametrize("name", NAMES)
def test_certificates_replay_across_the_packages(name):
    c, P, Q, mapping = carried(name)
    ref = run_pair(ref_api, c["P"], c["Q"], c, c["mapping"])
    port = run_pair(port_api, P, Q, c, mapping)
    assert port.verdict is ref.verdict
    assert pair_digest(P, Q, c["semantics"]) == ref_api.pair_digest(c["P"], c["Q"], c["semantics"])
    if ref.verdict is None:
        assert ref.certificate is None and port.certificate is None
        return
    ours, theirs = port.certificate, ref.certificate
    in_ref = ref_api.Certificate.from_json(ours.to_json())
    assert in_ref.replay().ok
    assert in_ref.replay(P=c["P"], Q=c["Q"]).ok
    in_port = Certificate.from_json(theirs.to_json())
    assert in_port.replay().ok
    assert in_port.replay(P=P, Q=Q).ok
    assert in_port.to_json() == ours.to_json()
    if not ours.windows:  # an exact match certifies with no window to tamper
        assert ours.kind == "exact"
        return
    for bad in (tampered(ours), Certificate.from_json(ref_api.tampered(theirs).to_json())):
        assert not bad.replay(P=P, Q=Q).ok
        assert not bad.replay().ok
        bad_in_ref = ref_api.Certificate.from_json(bad.to_json())
        assert not bad_in_ref.replay(P=c["P"], Q=c["Q"]).ok
        assert not bad_in_ref.replay().ok


CODEC = ("cert_two_filters", "cert_two_branches", "paper_mapping_matters", "union_with_udp",
         "unsupported_udf_change", "seeded5", "multi1", "gen7-s0-1", "gen11-s1-3")


@pytest.mark.parametrize("name", CODEC)
def test_codec_writes_the_references_bytes(name):
    """Every changed window's query pair, and the pair's operators, encode
    to the same JSON in both packages and decode back to equal objects."""
    c, P, Q, mapping = carried(name)
    rp = RefVersionPair(c["P"], c["Q"], c["mapping"] or ref_identity_mapping(c["P"], c["Q"]),
                        c["semantics"])
    pp = VersionPair(P, Q, mapping or identity_mapping(P, Q), c["semantics"])
    dump = lambda d: json.dumps(d, sort_keys=True)  # noqa: E731
    assert dump(serialize.ops_to_list(P.ops)) == dump(ref_serialize.ops_to_list(c["P"].ops))
    assert serialize.ops_from_list(serialize.ops_to_list(Q.ops)) == Q.ops
    for ch in pp.changes:
        win = ch.required_units
        qp = pp.to_query_pair(win)
        if qp is None:
            assert rp.to_query_pair(win) is None
            continue
        d = serialize.query_pair_to_dict(qp)
        assert dump(d) == dump(ref_serialize.query_pair_to_dict(rp.to_query_pair(win)))
        back = serialize.query_pair_from_dict(json.loads(dump(d)))
        assert back.fingerprint() == qp.fingerprint()


def test_format_version_is_the_references():
    from repro.api.certificate import CERTIFICATE_FORMAT_VERSION as ref_version
    from repro_torch.api.certificate import CERTIFICATE_FORMAT_VERSION

    assert CERTIFICATE_FORMAT_VERSION == ref_version == 2


# ---------------------------------------------------------------------------
# the port's replay contract
# ---------------------------------------------------------------------------


def _two_filter_pair(prefix="x", a_thresh=2):
    """P: src -> fa -> fb -> sink; Q: the filters swapped (equivalent)."""
    fa = op(f"{prefix}fa", D.FILTER, pred=Pred.cmp("a", ">", a_thresh))
    fb = op(f"{prefix}fb", D.FILTER, pred=Pred.cmp("b", "<", 5))

    def build(order):
        path = [f"{prefix}src"] + list(order) + [f"{prefix}sink"]
        return DataflowDAG(
            [op(f"{prefix}src", D.SOURCE, schema=SCHEMA), fa, fb,
             op(f"{prefix}sink", D.SINK, semantics=D.BAG)],
            [Link(x, y) for x, y in zip(path, path[1:])],
        )

    return build((fa.id, fb.id)), build((fb.id, fa.id))


def test_json_round_trip_is_byte_stable():
    P, Q = _two_filter_pair()
    cert = port_api.verify(P, Q, CFG).certificate
    restored = Certificate.from_json(cert.to_json())
    assert restored == cert and restored.to_json() == cert.to_json()
    assert restored.replay(P=P, Q=Q).ok


@pytest.mark.parametrize("payload", ["not json{", "{}", '{"version": 1}', "[]"])
def test_malformed_json_rejected(payload):
    with pytest.raises(CertificateFormatError):
        Certificate.from_json(payload)


def test_cache_hit_verdicts_produce_complete_certificates():
    cache = VerdictCache()
    P, Q = _two_filter_pair()
    cold = port_api.verify(P, Q, CFG, cache=cache)
    warm = port_api.verify(P, Q, CFG, cache=cache)
    assert cold.stats.ev_calls > 0
    assert warm.stats.ev_calls == 0 and warm.stats.cache_hits > 0
    assert warm.certificate.to_json() == cold.certificate.to_json()
    assert warm.certificate.replay(P=P, Q=Q).ok


def test_replay_uses_fresh_uncached_evs():
    cache = VerdictCache()
    P, Q = _two_filter_pair()
    cert = port_api.verify(P, Q, CFG, cache=cache).certificate
    for ev_name, fp in list(cache._entries):
        cache.put(ev_name, fp, False, 0.0)
    assert cert.replay().ok


def test_pair_bound_replay_rejects_foreign_pair():
    cert = port_api.verify(*_two_filter_pair("x"), CFG).certificate
    report = cert.replay(port_api.default_registry(), *_two_filter_pair("y", a_thresh=3))
    assert not report.ok
    assert any("different pair" in str(f) for f in report.failures)


def test_pair_bound_replay_rejects_truncated_decomposition():
    _, P, Q, _ = carried("cert_two_branches")
    cert = port_api.verify(P, Q, CFG).certificate
    assert len(cert.windows) >= 2
    truncated = dataclasses.replace(cert, windows=cert.windows[:1])
    assert truncated.replay().ok  # self-consistency alone cannot catch this
    report = truncated.replay(port_api.default_registry(), P, Q)
    assert not report.ok
    assert any("not covered" in str(f) for f in report.failures)


def test_tampered_ev_name_and_window_contents_fail_replay():
    P, Q = _two_filter_pair("x")
    cert = port_api.verify(P, Q, CFG).certificate
    other = port_api.verify(*_two_filter_pair("y", a_thresh=3), CFG).certificate
    i = next(i for i, w in enumerate(cert.windows) if w.kind == "ev")
    other_ev = next(w for w in other.windows if w.kind == "ev")
    for change in (dict(ev_name="no_such_ev"), dict(payload=other_ev.payload)):
        recs = list(cert.windows)
        recs[i] = dataclasses.replace(recs[i], **change)
        assert not dataclasses.replace(cert, windows=tuple(recs)).replay().ok


def test_forged_eq_from_neq_evidence_rejected():
    _, P, Q, _ = carried("cert_witness")
    cert = port_api.verify(P, Q, CFG).certificate
    assert cert.verdict is False
    forged = dataclasses.replace(cert, verdict=True, kind="decomposition")
    assert not forged.replay().ok
    assert not forged.replay(port_api.default_registry(), P, Q).ok


def test_empty_identical_record_rejected():
    forged = Certificate(
        verdict=True, kind="decomposition", semantics=D.BAG, mapping=(),
        windows=(WindowRecord(kind="identical", verdict=True,
                              payload={"p_ops": [], "q_ops": [], "p_links": [],
                                       "q_links": [], "forward": {}}),),
    )
    report = forged.replay()
    assert not report.ok
    assert any("no operators" in str(f) for f in report.failures)


def test_identical_under_mapping_requires_bijection():
    src, src2 = op("s", D.SOURCE, schema=SCHEMA), op("t", D.SOURCE, schema=SCHEMA)
    filt = op("y", D.FILTER, pred=Pred.cmp("a", ">", 1))
    assert not identical_under_mapping(
        {"a": src, "b": src2}, {"x": op("x", D.SOURCE, schema=SCHEMA), "y": filt},
        [], [], {"a": "x", "b": "x"},
    )


def test_forged_identical_record_rejected_by_bound_replay():
    P = DataflowDAG(
        [op("s", D.SOURCE, schema=SCHEMA), op("f", D.FILTER, pred=Pred.cmp("a", ">", 2)),
         op("k", D.SINK, semantics=D.BAG)],
        [Link("s", "f"), Link("f", "k")],
    )
    Q = P.replace_op(op("f", D.FILTER, pred=Pred.cmp("a", ">", 4)))
    fake_ops = [serialize.operator_to_dict(o) for o in P.ops.values()]
    forged = Certificate(
        verdict=True, kind="decomposition", semantics=D.BAG,
        mapping=tuple((i, i) for i in P.ops),
        windows=(WindowRecord(
            kind="identical", verdict=True, units=(0, 1, 2),
            payload={"p_ops": fake_ops, "q_ops": fake_ops,
                     "p_links": [["s", "f", 0], ["f", "k", 0]],
                     "q_links": [["s", "f", 0], ["f", "k", 0]],
                     "forward": {i: i for i in P.ops}},
        ),),
        pair_digest=pair_digest(P, Q, D.BAG),
        n_units=3,
    )
    assert forged.replay().ok  # self-consistency alone is fooled
    report = forged.replay(port_api.default_registry(), P, Q)
    assert not report.ok
