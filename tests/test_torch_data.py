"""The port's ``data/`` (``repro_torch.data``) on the CPU against the
reference's ``repro.data``, and the ingestion pipeline (paper use case 1)
through the port's ``ReuseManager`` against the reference's.

Exact equality throughout: the corpus table and its digest, each
pipeline version's ``dag_to_dict`` and content digest, the token streams,
``pack_batches``' arrays, and — for the four iterations of
``examples/iterative_analytics.py`` on 4,096 documents, the port at
``plane="torch", device="cpu"``, the reference at ``plane="numpy"`` — every
sink (``tables_identical``, object column of token lists included), every
``ReuseStats`` counter, and every certificate's JSON bytes and replay.
The ``tokens`` column must also survive the disk store's JSON and the
torch plane's FILTER untouched.

The port's ``tokenize_pack`` fills each token list with Python ints, where
the reference's holds numpy scalars until its disk store gives them back as
Python ints; ``tables_identical`` (the reference's rule in both packages)
tells the two apart, so a reference sink is compared through
``_python_ints``, which changes nothing but the type of those elements.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from repro import data as ref_data
from repro.api import VeerConfig as RefVeerConfig
from repro.api.serialize import dag_to_dict as ref_dag_to_dict
from repro.engine import table_digest as ref_table_digest
from repro.reuse import ReuseManager as RefReuseManager
from repro_torch import data
from repro_torch.api import VeerConfig
from repro_torch.api.serialize import dag_to_dict
from repro_torch.core import dag as D
from repro_torch.core.predicates import Pred
from repro_torch.data.synthetic import doc_tokens
from repro_torch.engine import (
    DiskMaterializationStore,
    execute,
    table_digest,
    tables_identical,
)
from repro_torch.reuse import ReuseManager

ROOT = pathlib.Path(__file__).resolve().parent.parent
KNOBS = [(0.25, 0), (0.6, 0), (0.25, None)]
REUSE_COUNTERS = ("submissions", "sink_hits", "sink_misses", "executions",
                  "dedup_skipped_writes", "verdict_cache_hits", "certified_reuses",
                  "interior_hits", "ops_executed", "ops_reused")


def _python_ints(t):
    """The reference's table ``t`` with each token list's elements as Python
    ints."""
    toks = np.empty(len(t), dtype=object)
    for i, v in enumerate(t.cols["tokens"]):
        toks[i] = [int(x) for x in v]
    return t.with_col("tokens", toks)


def _twin_versions():
    """The four versions of the port's ``examples/torch_iterative_analytics.py``."""
    path = ROOT / "examples" / "torch_iterative_analytics.py"
    spec = importlib.util.spec_from_file_location("_data_torch_iterative_analytics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [v for _, v in mod.iterations()]


def _ref_versions():
    """The reference example's versions, as its ``main`` builds them."""
    from repro.core import dag as RD
    from repro.core.predicates import Pred as RPred

    op = RD.Operator.make
    v1 = ref_data.ingestion_pipeline(min_quality=0.25, lang=0)
    v2 = RD.DataflowDAG(
        [op("corpus", RD.SOURCE, schema=ref_data.CORPUS_SCHEMA),
         op("lang_filter", RD.FILTER, pred=RPred.cmp("lang_id", "==", 0)),
         op("q_filter", RD.FILTER, pred=RPred.cmp("quality", ">", 0.25)),
         op("tokenize", RD.UDF, fn="tokenize_pack", out_schema=ref_data.CORPUS_SCHEMA + ("tokens",)),
         op("packed", RD.SINK, semantics=RD.BAG)],
        [RD.Link("corpus", "lang_filter"), RD.Link("lang_filter", "q_filter"),
         RD.Link("q_filter", "tokenize"), RD.Link("tokenize", "packed")])
    v3 = v2.replace_op(op("q_filter", RD.FILTER, pred=RPred.and_(
        RPred.cmp("quality", ">", 0.25), RPred.cmp("quality", ">", 0.1))))
    v4 = ref_data.ingestion_pipeline(min_quality=0.6, lang=0)
    return [v1, v2, v3, v4]


@pytest.mark.parametrize("n_docs,seed", [(0, 7), (1, 7), (512, 7), (4096, 3)])
def test_corpus_table_is_the_references(n_docs, seed):
    want = ref_data.corpus_table(n_docs, seed=seed)
    got = data.corpus_table(n_docs, seed=seed)
    assert tables_identical(got, want)
    assert table_digest(got) == ref_table_digest(want)


def test_doc_tokens_are_the_references():
    from repro.data.synthetic import doc_tokens as ref_doc_tokens

    for doc, length in ((0, 16), (1, 255), (123_456, 40), (999_999, 200)):
        np.testing.assert_array_equal(doc_tokens(doc, length), ref_doc_tokens(doc, length))
    assert doc_tokens(5, 64, vocab=100).max() < 100


@pytest.mark.parametrize("q,lang", KNOBS)
def test_ingestion_pipeline_is_the_references(q, lang):
    want = ref_data.ingestion_pipeline(min_quality=q, lang=lang)
    got = data.ingestion_pipeline(min_quality=q, lang=lang)
    assert dag_to_dict(got) == ref_dag_to_dict(want)
    assert got.content_digest() == want.content_digest()


def test_twin_example_builds_the_reference_examples_versions():
    twin = _twin_versions()
    assert [dag_to_dict(v) for v in twin] == [ref_dag_to_dict(v) for v in _ref_versions()]


@pytest.mark.parametrize("q,lang", KNOBS)
def test_packed_sink_and_batches_are_the_references(q, lang):
    from repro.engine import execute as ref_execute

    corpus = data.corpus_table(600)
    want = ref_execute(ref_data.ingestion_pipeline(min_quality=q, lang=lang),
                       {"corpus": ref_data.corpus_table(600)})["packed"]
    got = execute(data.ingestion_pipeline(min_quality=q, lang=lang), {"corpus": corpus},
                  device="cpu")["packed"]
    assert got.cols["tokens"].dtype == object and got.cols["tokens"].ndim == 1
    assert tables_identical(got, _python_ints(want)) and table_digest(got) == ref_table_digest(want)
    kw = dict(seq_len=64, batch=4, vocab=1000)
    ref_batches = list(ref_data.pack_batches(want, **kw))
    batches = list(data.pack_batches(got, **kw))
    assert len(batches) == len(ref_batches) > 3
    for a, b in zip(batches, ref_batches):
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_tokens_column_survives_the_disk_store_and_the_torch_plane(tmp_path):
    """The store writes the token lists as JSON and reads them back
    identical, with the same digest; a FILTER after ``tokenize_pack`` on the
    torch plane passes the column through untouched."""
    corpus = data.corpus_table(800)
    packed = execute(data.ingestion_pipeline(), {"corpus": corpus}, plane="numpy")["packed"]
    store = DiskMaterializationStore(str(tmp_path / "store"))
    store.put("k", packed)
    back = DiskMaterializationStore(str(tmp_path / "store")).get("k")
    assert back is not packed and tables_identical(back, packed)
    assert table_digest(back) == table_digest(packed)

    dag = data.ingestion_pipeline()
    dag = dag.remove_link(D.Link("tokenize", "packed"))
    dag = dag.add_op(D.Operator.make("long", D.FILTER, pred=Pred.cmp("length", ">", 100)))
    dag = dag.add_link(D.Link("tokenize", "long")).add_link(D.Link("long", "packed"))
    want = execute(dag, {"corpus": corpus}, plane="numpy")["packed"]
    got = execute(dag, {"corpus": corpus}, device="cpu")["packed"]
    assert 0 < len(got) < len(packed)
    assert tables_identical(got, want)


def test_reuse_manager_ingestion_equals_the_references(tmp_path):
    """Paper use case 1, the four iterations on 4,096 documents: the port's
    manager (torch plane, CPU) against the reference's (numpy plane)."""
    ref = RefReuseManager(str(tmp_path / "ref"), config=RefVeerConfig())
    port = ReuseManager(str(tmp_path / "port"), config=VeerConfig(), device="cpu")
    assert port.plane == "torch" and ref.plane == "numpy"
    ref_corpus, corpus = ref_data.corpus_table(4096), data.corpus_table(4096)
    versions = _twin_versions()
    for k, (rv, v) in enumerate(zip(_ref_versions(), versions)):
        a = ref.submit(rv, {"corpus": ref_corpus})
        b = port.submit(v, {"corpus": corpus})
        assert set(a) == set(b) == {"packed"}
        assert tables_identical(b["packed"], _python_ints(a["packed"])), k
        for field in REUSE_COUNTERS:
            assert getattr(port.stats, field) == getattr(ref.stats, field), (k, field)
    assert (port.stats.sink_hits, port.stats.executions) == (2, 2)
    assert len(port.certificates) == len(ref.certificates) == 2
    for (vid, prev, cert), (rvid, rprev, rcert) in zip(port.certificates, ref.certificates):
        assert (vid, prev) == (rvid, rprev)
        assert cert.verdict == rcert.verdict is True
        assert cert.to_json() == rcert.to_json()
        assert cert.replay().ok and rcert.replay().ok
