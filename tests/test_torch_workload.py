"""The port's edit-session workload layer (``repro_torch.workload``) held
against the reference package's on the CPU.

Exact throughout: the same ``WorkloadConfig`` must generate the same
sessions in both packages (every version's ``dag_to_dict``, every mapping
and oracle label, every source table's bytes), the corpus helpers must give
the same examples, and ``replay_sessions`` must report no oracle violation
on the port's service and fleet (``device="cpu"``, the torch plane) with
the reference's verdict census.  The cases of
``tests/test_workload_stress.py`` run here against the port.
"""

import io
import json
import random
import threading
from concurrent.futures import Future

import pytest

from repro import api as ref_api
from repro import workload as ref_workload
from repro.api.serialize import dag_to_dict as ref_dag_to_dict

from repro_torch import api as port_api
from repro_torch.core import dag as D
from repro_torch.api.serialize import dag_to_dict
from repro_torch.engine import execute
from repro_torch.engine.table import Table
from repro_torch.service import ServiceBusy, VerificationService, VersionChainSession
from repro_torch.service.server import _Job
from repro_torch.workload import (
    EXPECTED_EQ,
    SessionGenerator,
    WindowExample,
    WorkloadConfig,
    WorkloadConfigError,
    canonical_sink_bytes,
    dump_windows,
    load_windows,
    replay_sessions,
    windows_from_certificate,
)
from repro_torch.workload import workloads as W
from repro_torch.workload.replay import canonical_results_bytes

FAST = dict(seed=7, sessions=3, clients=3, chain_length=6, workloads=("W1", "W5", "W8"),
            rows=12, max_decompositions=60)
PORT_FAST = WorkloadConfig(**FAST)
SVC_CONFIG = port_api.VeerConfig(evs=("equitas", "spes", "udp"), max_decompositions=60)
# generator configurations held against the reference: every shape and family
GEN_CASES = {
    "fast": FAST,
    "all_shapes": dict(seed=0, sessions=8, chain_length=8, rows=9),
    "predicate_heavy": dict(seed=3, sessions=4, chain_length=7, rows=10,
                            edit_mix=(("predicate", 0.6), ("churn_revert", 0.4))),
    "rename_boundary": dict(seed=11, sessions=4, chain_length=7, rows=10,
                            edit_mix=(("rename_storm", 0.5), ("boundary", 0.5))),
}


def _ref_sessions(cfg):
    return ref_workload.SessionGenerator(ref_workload.WorkloadConfig(**cfg)).generate()


def _port_sessions(cfg):
    return SessionGenerator(WorkloadConfig(**cfg)).generate()


def _table_bytes(t):
    return [(c, str(t.cols[c].dtype),
             repr(t.cols[c].tolist()) if t.cols[c].dtype == object else t.cols[c].tobytes())
            for c in t.order]


# ---------------------------------------------------------------------------
# the generator: the same sessions in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GEN_CASES))
def test_sessions_equal_the_reference(name):
    ref, port = _ref_sessions(GEN_CASES[name]), _port_sessions(GEN_CASES[name])
    assert len(ref) == len(port) > 0
    for r, p in zip(ref, port):
        assert (p.session_id, p.workload, p.seed) == (r.session_id, r.workload, r.seed)
        assert [dag_to_dict(v) for v in p.versions] == [ref_dag_to_dict(v) for v in r.versions]
        assert [(x.index, x.kind, x.expected) for x in p.pairs] == \
            [(x.index, x.kind, x.expected) for x in r.pairs]
        assert [x.mapping and sorted(x.mapping.forward.items()) for x in p.pairs] == \
            [x.mapping and sorted(x.mapping.forward.items()) for x in r.pairs]
        assert sorted(p.sources) == sorted(r.sources)
        for sid in r.sources:
            assert _table_bytes(p.sources[sid]) == _table_bytes(r.sources[sid])
        assert sum(x.expected == EXPECTED_EQ for x in p.pairs) == \
            sum(x.expected == ref_workload.EXPECTED_EQ for x in r.pairs)
        assert p.signature() == r.signature()


@pytest.mark.parametrize("shape", sorted(W.WORKLOADS))
def test_workload_shapes_and_tables_equal_the_reference(shape):
    from benchmarks import workloads as ref_w

    P, ref_P = W.WORKLOADS[shape](), ref_w.WORKLOADS[shape]()
    assert dag_to_dict(P) == ref_dag_to_dict(ref_P)
    got, want = W.random_tables(P, seed=5, n=17), ref_w.random_tables(ref_P, seed=5, n=17)
    assert {s: _table_bytes(t) for s, t in got.items()} == \
        {s: _table_bytes(t) for s, t in want.items()}
    for fn in ("apply_equivalent_edits", "apply_inequivalent_edits"):
        q = getattr(W, fn)(P, 3, rng=random.Random(9), prefix="x_")
        ref_q = getattr(ref_w, fn)(ref_P, 3, rng=random.Random(9), prefix="x_")
        assert dag_to_dict(q) == ref_dag_to_dict(ref_q)
    for hops in (0, 1, 2):
        try:
            want = ref_dag_to_dict(ref_w.edits_with_distance(ref_P, hops))
        except ValueError:
            with pytest.raises(ValueError):
                W.edits_with_distance(P, hops)
            continue
        assert dag_to_dict(W.edits_with_distance(P, hops)) == want


def test_config_roundtrips_and_defaults_validate():
    cfg = PORT_FAST.validate()
    again = WorkloadConfig.from_json(cfg.to_json())
    assert again == cfg and again.to_json() == cfg.to_json()
    assert WorkloadConfig().validate().total_pairs > 0
    assert WorkloadConfig().plane == "torch"
    ref = json.loads(ref_workload.WorkloadConfig(**FAST).to_json())
    port = json.loads(cfg.to_json())
    assert {k for k in ref if ref[k] != port[k]} == {"plane"}


@pytest.mark.parametrize(
    "changes",
    [
        {"sessions": 0},
        {"chain_length": 1},
        {"qps": -1.0},
        {"workloads": ()},
        {"workloads": ("W1", "W99")},
        {"edit_mix": ()},
        {"edit_mix": (("nope", 1.0),)},
        {"edit_mix": (("equivalent", 1.0), ("equivalent", 2.0))},
        {"edit_mix": (("equivalent", 0.0),)},
        {"rows": -3},
        {"max_decompositions": 0},
        {"plane": "jax"},
    ],
)
def test_config_rejects_bad_values(changes):
    with pytest.raises(WorkloadConfigError):
        WorkloadConfig(**changes).validate()


def test_config_rejects_unknown_fields():
    with pytest.raises(WorkloadConfigError):
        WorkloadConfig.from_dict({"sessions": 2, "not_a_field": 1})


def test_same_seed_generates_byte_identical_sessions():
    a = SessionGenerator(PORT_FAST).generate()
    b = SessionGenerator(PORT_FAST).generate()
    assert [s.signature() for s in a] == [s.signature() for s in b]
    assert SessionGenerator(PORT_FAST).session(1).signature() == a[1].signature()
    c = SessionGenerator(PORT_FAST.replace(seed=PORT_FAST.seed + 1)).generate()
    assert [s.signature() for s in a] != [s.signature() for s in c]


def test_edit_generators_are_seed_deterministic():
    P = W.WORKLOADS["W5"]()
    for fn in (W.apply_equivalent_edits, W.apply_inequivalent_edits):
        random.seed(12345)  # poisoning global state must not matter
        q1 = json.dumps(dag_to_dict(fn(P, 3, seed=9)), sort_keys=True)
        random.seed(999)
        q2 = json.dumps(dag_to_dict(fn(P, 3, seed=9)), sort_keys=True)
        assert q1 == q2


def _exec_bytes(session, idx, **kw):
    dag = session.versions[idx]
    srcs = {k: v for k, v in session.sources.items() if k in dag.ops}
    return canonical_results_bytes(dag, execute(dag, srcs, **kw))


def test_expected_eq_pairs_are_execution_equal_on_both_planes():
    """Equivalence-by-construction pairs are execution-equal, and the torch
    plane's sinks have the numpy plane's canonical bytes."""
    for s in SessionGenerator(PORT_FAST).generate():
        assert len(s.versions) == PORT_FAST.chain_length
        assert set(s.sources) == set(s.versions[0].sources)
        numpy = [_exec_bytes(s, k, plane="numpy") for k in range(len(s.versions))]
        assert [_exec_bytes(s, k, device="cpu") for k in range(len(s.versions))] == numpy
        for p in s.pairs:
            if p.expected == EXPECTED_EQ:
                assert numpy[p.index - 1] == numpy[p.index], (s.session_id, p.index, p.kind)


def test_rename_storm_preserves_sources_sinks_and_content():
    cfg = PORT_FAST.replace(edit_mix=(("rename_storm", 1.0),), chain_length=3)
    s = SessionGenerator(cfg).session(0)
    P, Q = s.versions[0], s.versions[1]
    planned = s.pairs[0]
    assert planned.kind == "rename_storm" and planned.mapping is not None
    for pid, qid in planned.mapping.forward.items():
        if P.ops[pid].op_type in (D.SOURCE, D.SINK):
            assert pid == qid
        else:
            assert pid != qid
    assert set(P.sources) == set(Q.sources) and set(P.sinks) == set(Q.sinks)
    res = port_api.verify(P, Q, SVC_CONFIG, mapping=planned.mapping)
    assert res.verdict is True and res.certificate.replay(None, P, Q).ok


def test_canonical_sink_bytes_semantics():
    t1 = Table.from_rows(("a", "b"), [(1, 2), (3, 4)])
    t2 = Table.from_rows(("a", "b"), [(3, 4), (1, 2)])
    assert canonical_sink_bytes(t1, D.BAG) == canonical_sink_bytes(t2, D.BAG)
    assert canonical_sink_bytes(t1, D.ORDERED) != canonical_sink_bytes(t2, D.ORDERED)
    dup = Table.from_rows(("a", "b"), [(1, 2), (1, 2), (3, 4)])
    assert canonical_sink_bytes(dup, D.SET) == canonical_sink_bytes(t1, D.SET)
    assert canonical_sink_bytes(dup, D.BAG) != canonical_sink_bytes(t1, D.BAG)


# ---------------------------------------------------------------------------
# the replay driver on the port's service and fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_replay():
    cfg = ref_workload.WorkloadConfig(**FAST)
    result = ref_workload.replay_sessions(
        ref_workload.SessionGenerator(cfg).generate(), cfg, collect_windows=True)
    assert result.ok, result.summary()
    return result


@pytest.mark.parametrize("backend", ["service", "fleet-local", "fleet-remote"])
def test_replay_has_no_oracle_violation_and_the_reference_census(backend, reference_replay):
    fleet = 0 if backend == "service" else 2
    tier = "remote" if backend.endswith("remote") else "local"
    cfg = PORT_FAST.replace(fleet=fleet, shared_tier=tier)
    result = replay_sessions(SessionGenerator(cfg).generate(), cfg, collect_windows=True,
                             exec_reuse=backend != "fleet-local", device="cpu")
    assert result.ok, result.summary()
    assert result.pairs == cfg.total_pairs == reference_replay.pairs
    assert result.verdicts == reference_replay.verdicts
    assert result.certified == result.decided == reference_replay.certified
    if backend == "service":
        assert [w.to_dict() for w in result.windows] == \
            [w.to_dict() for w in reference_replay.windows]


def test_replay_with_delta_execution_and_guidance():
    cfg = PORT_FAST.replace(sessions=2, clients=2, exec_mode="delta", guidance="model",
                            edit_mix=(("predicate", 0.7), ("equivalent", 0.3)))
    result = replay_sessions(SessionGenerator(cfg).generate(), cfg, exec_reuse=True,
                             device="cpu")
    assert result.ok, result.summary()
    assert result.pairs == cfg.total_pairs


def test_churn_revert_rehits_pair_cache():
    cfg = PORT_FAST.replace(edit_mix=(("churn_revert", 1.0),), chain_length=8,
                            sessions=2, clients=2)
    sessions = SessionGenerator(cfg).generate()
    result = replay_sessions(sessions, cfg, device="cpu")
    assert result.ok, result.summary()
    assert result.reused >= len(sessions)
    assert result.pair_cache_stats["hits"] == result.reused


def test_replay_driver_counts_busy_and_drops_no_version():
    cfg = PORT_FAST.replace(sessions=2, clients=2)
    result = replay_sessions(SessionGenerator(cfg).generate(), cfg, workers=1,
                             queue_size=1, device="cpu")
    assert result.ok, result.summary()
    assert result.pairs == cfg.total_pairs
    assert result.busy_rejections > 0


def test_generated_burst_traffic_hits_backpressure_and_recovers():
    session = SessionGenerator(PORT_FAST.replace(chain_length=10)).session(0)
    gate = threading.Event()
    svc = VerificationService(config=SVC_CONFIG, workers=1, queue_size=1, device="cpu")
    accepted, rejected = [], 0
    try:
        blocker = _Job(client=None, ticket=0, fn=lambda: gate.wait(30), future=Future())
        with svc._lock:
            svc._pending += 1
        svc._queue.put(blocker)
        svc.submit("burst", session.versions[0])
        accepted.append(session.versions[0])
        for v in session.versions[1:]:
            try:
                svc.submit("burst", v, block=False)
                accepted.append(v)
            except ServiceBusy:
                rejected += 1
        assert rejected > 0, "burst never saturated the queue"
        gate.set()
        for v in session.versions[len(accepted):]:
            svc.submit("burst", v, timeout=60)
            accepted.append(v)
        report = svc.drain()
        assert report.errors == []
        assert len(report.sessions["burst"].pairs) == len(accepted) - 1
        with VersionChainSession(config=SVC_CONFIG) as seq:
            for v in accepted:
                seq.submit(v)
        assert report.sessions["burst"].verdicts == seq.report().verdicts
    finally:
        gate.set()
        svc.close(save=False)


# ---------------------------------------------------------------------------
# the labeled-window corpus
# ---------------------------------------------------------------------------


def test_window_corpus_round_trips(reference_replay):
    windows = [WindowExample.from_dict(w.to_dict()) for w in reference_replay.windows]
    assert windows
    buf = io.StringIO()
    report = dump_windows(windows, buf, dedupe=False)
    assert report.written == len(windows) and report.dropped_duplicates == 0
    buf.seek(0)
    assert list(load_windows(buf)) == windows
    ref_buf = io.StringIO()
    ref_workload.dump_windows(reference_replay.windows, ref_buf, dedupe=False)
    assert buf.getvalue() == ref_buf.getvalue()
    deduped, ref_deduped = io.StringIO(), io.StringIO()
    got = dump_windows(windows, deduped)
    want = ref_workload.dump_windows(reference_replay.windows, ref_deduped)
    assert deduped.getvalue() == ref_deduped.getvalue()
    assert (got.written, got.dropped_duplicates, got.label_counts) == \
        (want.written, want.dropped_duplicates, want.label_counts)


@pytest.mark.parametrize("session_index", [0, 1, 2])
def test_windows_from_certificate_equal_the_reference(session_index):
    ref_s = _ref_sessions(FAST)[session_index]
    s = _port_sessions(FAST)[session_index]
    ref_cfg = ref_api.VeerConfig(evs=("equitas", "spes", "udp"), max_decompositions=60)
    seen = 0
    for p, rp in zip(s.pairs, ref_s.pairs):
        res = port_api.verify(s.versions[p.index - 1], s.versions[p.index], SVC_CONFIG,
                              mapping=p.mapping)
        ref_res = ref_api.verify(ref_s.versions[p.index - 1], ref_s.versions[p.index],
                                 ref_cfg, mapping=rp.mapping)
        if ref_res.certificate is None:
            assert res.certificate is None
            continue
        meta = dict(workload=s.workload, session_id=s.session_id, pair_index=p.index,
                    family=p.kind, expected=p.expected)
        got = windows_from_certificate(res.certificate, **meta)
        want = ref_workload.windows_from_certificate(ref_res.certificate, **meta)
        assert [w.to_dict() for w in got] == [w.to_dict() for w in want]
        assert len(got) == len(res.certificate.windows)
        seen += 1
    assert seen > 0
