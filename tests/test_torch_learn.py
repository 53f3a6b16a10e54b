"""The port's learned search guidance (``repro_torch.learn``) held against
the reference package's on the CPU.

Exact throughout: feature vectors bit for bit (live query pairs and
harvested examples), the committed ``pretrained.json`` and the guidance it
loads, guided verdicts with their deterministic ``VeerStats`` and
``Certificate.to_json()`` bytes under ``guidance="model"``, and the bundle
``harvest`` plus ``train_guidance`` write from a small seeded corpus.  The
guidance cases of ``tests/test_guidance.py`` run here against the port.
"""

import functools
import json

import pytest

from repro import api as ref_api
from repro import learn as ref_learn
from repro.api.serialize import dag_to_dict, query_pair_to_dict
from repro.core.verifier import Veer as RefVeer
from repro.workload import SessionGenerator as RefSessionGenerator
from repro.workload import WorkloadConfig as RefWorkloadConfig

from repro_torch import api as port_api
from repro_torch import carry
from repro_torch import learn
from repro_torch.api import default_registry
from repro_torch.api.certificate import Certificate, certificate_from_evidence
from repro_torch.core.edits import EditMapping
from repro_torch.api.serialize import query_pair_from_dict
from repro_torch.core.verifier import Veer
from repro_torch.workload import WindowExample, WorkloadConfig, default_veer_config
from repro_torch.workload.workloads import WORKLOADS, apply_equivalent_edits

BUDGET = 3_000
COUNTERS = (
    "decompositions_explored", "windows_formed", "windows_verified", "ev_calls",
    "segments", "mappings_tried", "fast_inequivalence_hit", "cache_hits",
    "windows_deduped", "ev_calls_saved", "decompositions_to_first_certificate",
    "ev_attempts", "budget_exhausted",
)


def _carry(dag):
    return carry.from_reference(dag_to_dict(dag), {})[0]


def _carry_mapping(mapping):
    return None if mapping is None else EditMapping.make(dict(mapping.p_to_q))


@functools.lru_cache(maxsize=None)
def _session_pairs():
    """(name, reference P, Q, mapping) over a seeded corpus of every shape."""
    out = []
    cfg = RefWorkloadConfig(seed=4, sessions=4, chain_length=5, rows=9, max_decompositions=60)
    for s in RefSessionGenerator(cfg).generate():
        for p in s.pairs:
            out.append((f"{s.session_id}-{p.index}-{p.kind}", s.versions[p.index - 1],
                        s.versions[p.index], p.mapping))
    return tuple(out)


PAIR_NAMES = tuple(n for n, *_ in _session_pairs())


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def _observed_windows():
    """Every window the reference's Veer⁺ decides on the corpus: its
    query pair, unit count, fingerprint and the reference's feature vector."""
    rows = []

    def observer(ctx, win, out):
        qp = ctx.query_pair(win)
        if qp is None:
            return
        n, fp = len(ctx.units_tuple(win)), ctx.fingerprint(win)
        rows.append((query_pair_to_dict(qp), n, fp,
                     ref_learn.features_from_query_pair(qp, n, fp)))

    for _, P, Q, mapping in _session_pairs():
        RefVeer(ref_api.default_registry().build(), segmentation=True, pruning=True,
                ranking=True, fast_inequivalence=True, eager_verify=True,
                try_all_mappings=True, max_decompositions=60,
                window_observer=observer).verify(P, Q, mapping)
    return rows


def test_features_from_query_pair_equal_the_reference():
    rows = _observed_windows()
    assert len(rows) > 50
    for d, n, fp, want in rows:
        qp = query_pair_from_dict(d)
        got = learn.features_from_query_pair(qp, n, fp)
        assert len(got) == len(learn.FEATURE_NAMES)
        assert [x.hex() for x in got] == [x.hex() for x in want]


@pytest.fixture(scope="module")
def harvested():
    kw = dict(seed=3, sessions=2, chain_length=4, max_decompositions=60)
    return ref_learn.harvest(**kw), learn.harvest(**kw)


def test_harvest_and_features_from_example_equal_the_reference(harvested):
    ref, port = harvested
    assert len(port) == len(ref) > 0
    assert [e.to_dict() for e in port] == [e.to_dict() for e in ref]
    featurized = 0
    for ex, ref_ex in zip(port, ref):
        got, want = learn.features_from_example(ex), ref_learn.features_from_example(ref_ex)
        assert got == want
        featurized += got is not None
    assert featurized > 0


def test_train_guidance_writes_the_references_bundle(harvested):
    ref, port = harvested
    model, stats = learn.train_guidance(port, seed=3)
    ref_model, ref_stats = ref_learn.train_guidance(ref, seed=3)
    assert model.to_json() == ref_model.to_json()
    assert json.dumps(stats, sort_keys=True) == json.dumps(ref_stats, sort_keys=True)
    assert model.feature_names == tuple(learn.FEATURE_NAMES)
    assert set(model.evs) <= set(port_api.DEFAULT_EV_NAMES)


def test_feature_vector_names_match_the_reference():
    assert learn.FEATURE_NAMES == ref_learn.FEATURE_NAMES
    assert "cap_frac_jaxpr" in learn.FEATURE_NAMES and "cap_all_jaxpr" in learn.FEATURE_NAMES
    from repro_torch.learn import features as F

    assert {n: sorted(s) for n, s in F.capability_sets().items()} == \
        {n: sorted(s) for n, s in ref_learn.features.capability_sets().items()}


# ---------------------------------------------------------------------------
# the committed model
# ---------------------------------------------------------------------------


def test_pretrained_artifact_is_the_references():
    assert learn.PRETRAINED_PATH.read_bytes() == ref_learn.PRETRAINED_PATH.read_bytes()
    g, ref_g = learn.load_guidance(), ref_learn.load_guidance()
    assert isinstance(g, learn.SearchGuidance)
    assert g.model.to_json() == ref_g.model.to_json()
    assert g.model.feature_names == tuple(learn.FEATURE_NAMES)
    assert sorted(g.model.evs) == sorted(port_api.DEFAULT_EV_NAMES)
    assert g.model.meta.get("window", {}).get("n", 0) > 0


def test_load_guidance_from_a_path_and_a_missing_one(tmp_path):
    path = tmp_path / "g.json"
    learn.load_guidance().model.save(path)
    assert learn.load_guidance(str(path)).model == learn.load_guidance().model
    with pytest.raises(FileNotFoundError):
        learn.load_guidance(str(tmp_path / "absent.json"))


def test_feature_contract_rejects_mismatched_model():
    model = learn.GuidanceModel(feature_names=("not", "the", "contract"),
                                window=learn.LogisticModel.constant(3, 0.5))
    with pytest.raises(ValueError):
        learn.check_feature_contract(model)
    with pytest.raises(ValueError):
        learn.SearchGuidance(model)


_X = [[0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.1, 0.9, 0.1], [0.8, 0.0, 0.9], [0.0, 0.8, 0.0]]
_Y = [0, 1, 0, 1, 0]


def test_logistic_training_equals_the_reference():
    for seed in (0, 7):
        got = learn.LogisticModel.train(_X, _Y, seed=seed)
        want = ref_learn.LogisticModel.train(_X, _Y, seed=seed)
        assert got.to_dict() == want.to_dict()
        for x in _X:
            assert got.predict(x) == want.predict(x)
    assert learn.LogisticModel.train(_X, [1] * 5).to_dict() == \
        ref_learn.LogisticModel.train(_X, [1] * 5).to_dict()


# ---------------------------------------------------------------------------
# guided verification: the reference's verdicts, counters and certificates
# ---------------------------------------------------------------------------


def _outcome(result):
    cert = result.certificate
    return (result.verdict, {k: getattr(result.stats, k) for k in COUNTERS},
            cert.to_json() if cert is not None else None)


@pytest.mark.parametrize("backend", ["bitmask", "reference"])
@pytest.mark.parametrize("name", PAIR_NAMES)
def test_guided_verification_matches_the_reference(name, backend):
    _, P, Q, mapping = next(c for c in _session_pairs() if c[0] == name)
    ref = ref_api.verify(P, Q, ref_api.VeerConfig(guidance="model", max_decompositions=60,
                                                  search_backend=backend), mapping=mapping)
    got = port_api.verify(_carry(P), _carry(Q),
                          port_api.VeerConfig(guidance="model", max_decompositions=60,
                                              search_backend=backend),
                          mapping=_carry_mapping(mapping))
    assert _outcome(got) == _outcome(ref)
    if got.certificate is not None:
        assert got.certificate.replay(P=_carry(P), Q=_carry(Q)).ok


def _w4_pair(n_changes, seed=0):
    P = WORKLOADS["W4"]()
    return P, apply_equivalent_edits(P, n_changes, seed=seed)


def _run(P, Q, *, backend="bitmask", **kw):
    veer = Veer(default_registry().build(), search_backend=backend,
                max_decompositions=BUDGET, **kw)
    v, s, ev = veer.verify_with_evidence(P, Q)
    cert = certificate_from_evidence(ev)
    return v, s, (cert.to_json() if cert is not None else None)


def test_guided_acceptance_on_w4_matches_the_reference():
    """Within the budget that strands the blind search, guidance certifies
    far inside it, with the reference's counts."""
    from benchmarks.workloads import apply_equivalent_edits as ref_edits
    from benchmarks.workloads import build_workloads

    g = learn.load_guidance()
    P, Q = _w4_pair(12)
    blind_v, blind_s, _ = _run(P, Q)
    assert blind_v is None and blind_s.budget_exhausted
    guided = {b: _run(P, Q, backend=b, ranking=True, eager_verify=True, guidance=g)
              for b in ("bitmask", "reference")}
    v, s, cert = guided["bitmask"]
    assert v is True and s.decompositions_to_first_certificate * 5 <= BUDGET
    assert Certificate.from_json(cert).replay(P=P, Q=Q).ok
    assert (v, s.decompositions_explored, dict(s.ev_attempts), cert) == \
        (guided["reference"][0], guided["reference"][1].decompositions_explored,
         dict(guided["reference"][1].ev_attempts), guided["reference"][2])
    rP = build_workloads()["W4"]
    ref_veer = RefVeer(ref_api.default_registry().build(), max_decompositions=BUDGET,
                       ranking=True, eager_verify=True, guidance=ref_learn.load_guidance())
    rv, rs, rev = ref_veer.verify_with_evidence(rP, ref_edits(rP, 12, seed=0))
    assert rv is True
    assert s.decompositions_to_first_certificate == rs.decompositions_to_first_certificate
    assert dict(s.ev_attempts) == dict(rs.ev_attempts)
    assert cert == ref_api.certificate_from_evidence(rev).to_json()


class _NullGuidance:
    """Constant-score guidance: the guided heap degrades to the unguided one."""

    def decomposition_score(self, ctx, windows):
        return 0.0

    def ev_order(self, ctx, win, valid):
        return valid


@pytest.mark.parametrize("n_changes", [4, 8])
def test_constant_guidance_is_byte_identical_to_unguided(n_changes):
    P, Q = _w4_pair(n_changes)
    base_v, base_s, base_cert = _run(P, Q, ranking=True)
    null_v, null_s, null_cert = _run(P, Q, ranking=True, guidance=_NullGuidance())
    assert null_v == base_v and null_cert == base_cert
    assert null_s.decompositions_explored == base_s.decompositions_explored
    g_v, _, g_cert = _run(P, Q, ranking=True, eager_verify=True,
                          guidance=learn.load_guidance())
    assert g_v is True and Certificate.from_json(g_cert).replay(P=P, Q=Q).ok
    if base_v is not None:
        assert g_v == base_v


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def test_config_builds_guided_verifier_and_roundtrips():
    cfg = port_api.VeerConfig(guidance="model", max_decompositions=BUDGET)
    assert isinstance(cfg.build().guidance, learn.SearchGuidance)
    assert port_api.VeerConfig.from_json(cfg.to_json()) == cfg
    assert port_api.VeerConfig().build().guidance is None
    with pytest.raises(port_api.ConfigError):
        port_api.VeerConfig(guidance="magic").validate()
    with pytest.raises(port_api.ConfigError):
        port_api.VeerConfig(guidance="none", guidance_path="/x.json").validate()


def test_workload_config_threads_guidance():
    assert default_veer_config(WorkloadConfig(guidance="model").validate()).guidance == "model"
    assert default_veer_config(WorkloadConfig()).guidance == "none"
    with pytest.raises(ValueError):
        WorkloadConfig(guidance="zzz").validate()


def test_dedupe_windows_by_fingerprint():
    from repro_torch.workload import dedupe_windows

    def ex(fp, verdict=True):
        return WindowExample(workload="W1", session_id="s0", pair_index=1,
                             family="equivalent", expected="eq", record_kind="ev",
                             cert_kind="EXACT", verdict=verdict, fingerprint=fp,
                             units=(0,), op_hist={"Filter": 1}, topology={"p_ops": 1})

    got = dedupe_windows([ex("a"), ex("b"), ex("a", False), ex(None), ex(None)])
    assert [e.fingerprint for e in got] == ["a", "b", None]
