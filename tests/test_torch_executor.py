"""The port's executor and stores against the reference package's.

Per-operator content digests must be equal across the packages for the
same DAG and sources (they hash operator signatures and table bytes), and
execution with reuse — materialize one version, serve the next from the
store — must give the reference's sinks and accounting on the torch plane.
"""
import os

import numpy as np
import pytest

from repro.api.serialize import dag_to_dict
from repro.core import dag as D
from repro.core.dag import DataflowDAG, Link, Operator
from repro.core.predicates import LinExpr, Pred
from repro.engine import InMemoryMaterializationStore as RefMemStore
from repro.engine import Table as RTable
from repro.engine import table_digest as ref_table_digest
from repro.engine import tables_identical as ref_identical
from repro.engine.executor import ExecutionPlan as RefPlan
from repro.service.synthetic import make_chain
from repro_torch.carry import from_reference
from repro_torch.engine import (
    DiskMaterializationStore,
    ExecutionPlan,
    InMemoryMaterializationStore,
    Table,
    table_digest,
)


def _sources_for(version, seed=0, n=150):
    rng = np.random.default_rng(seed)
    out = {}
    for sid in version.sources:
        schema = version.ops[sid].get("schema")
        out[sid] = RTable(
            {c: rng.integers(-2, 7, n).astype(np.float64) for c in schema},
            list(schema),
        )
    return out


def _carry(dag, sources):
    return from_reference(
        dag_to_dict(dag),
        {sid: {c: t.cols[c] for c in t.order} for sid, t in sources.items()},
    )


def _chain(seed):
    rng = np.random.default_rng(seed)
    return make_chain(int(rng.integers(3, 6)), heavy=bool(seed % 2))


def _linear(n_filters=12):
    ops = [Operator.make("src", D.SOURCE, schema=("a", "b", "c"))]
    links = []
    prev = "src"
    for i in range(n_filters):
        ops.append(Operator.make(f"f{i}", D.FILTER, pred=Pred.cmp("a", "<=", 10 - i % 3)))
        links.append(Link(prev, f"f{i}"))
        prev = f"f{i}"
    ops.append(Operator.make("sink", D.SINK, semantics=D.BAG))
    links.append(Link(prev, "sink"))
    return DataflowDAG(ops, links)


@pytest.mark.parametrize("seed", range(4))
def test_content_digests_equal_reference(seed):
    for version in _chain(seed):
        sources = _sources_for(version, seed=seed)
        pdag, psrc = _carry(version, sources)
        assert pdag.content_digest() == version.content_digest()
        assert (ExecutionPlan(pdag, psrc, plane="numpy").digests
                == RefPlan(version, sources).digests)
        for sid in sources:
            assert table_digest(psrc[sid]) == ref_table_digest(sources[sid])


@pytest.mark.parametrize("seed", range(4))
def test_reuse_chain_matches_reference(seed):
    """Each version materializes into the store and is served from it:
    the torch plane's sinks, digests and accounting equal the reference's."""
    chain = _chain(seed)
    sources = _sources_for(chain[0], seed=seed)
    ref_store, store = RefMemStore(), InMemoryMaterializationStore()
    reused = 0
    for version in chain:
        srcs = {k: v for k, v in sources.items() if k in version.ops}
        pdag, psrc = _carry(version, srcs)
        want = RefPlan(version, srcs).run(
            store=ref_store, serve_from_store=True, materialize=True)
        got = ExecutionPlan(pdag, psrc, plane="torch", device="cpu").run(
            store=store, serve_from_store=True, materialize=True)
        for s, table in want.results.items():
            assert ref_identical(table, RTable(got.results[s].cols, got.results[s].order))
            assert table_digest(got.results[s]) == ref_table_digest(table)
        for field in ("ops_total", "ops_executed", "ops_reused", "ops_skipped",
                      "tables_served", "store_writes", "store_dedup_skipped"):
            assert getattr(got.stats, field) == getattr(want.stats, field), field
        assert got.reused_ops == want.reused_ops
        reused += got.stats.ops_reused
    assert reused > 0


def test_edit_below_join_serves_upstream_from_store():
    ops = [
        Operator.make("l", D.SOURCE, schema=("k", "x")),
        Operator.make("r", D.SOURCE, schema=("k", "y")),
        Operator.make("p", D.PROJECT, cols=(("k", "k"), ("x2", LinExpr.make({"x": 2}, 1)))),
        Operator.make("j", D.JOIN, on=(("k", "k"),), how="left_outer"),
        Operator.make("f", D.FILTER, pred=Pred.cmp("x2", "<=", 9)),
        Operator.make("sink", D.SINK, semantics=D.BAG),
    ]
    links = [Link("l", "p"), Link("p", "j", 0), Link("r", "j", 1),
             Link("j", "f"), Link("f", "sink")]
    v1 = DataflowDAG(ops, links)
    v2 = v1.replace_op(v1.ops["f"].with_props(pred=Pred.cmp("x2", "<=", 5)))
    rng = np.random.default_rng(2)
    sources = {
        "l": RTable({"k": rng.integers(0, 20, 200).astype(np.float64),
                     "x": rng.integers(0, 9, 200).astype(np.float64)}, ["k", "x"]),
        "r": RTable({"k": rng.integers(0, 20, 50).astype(np.float64),
                     "y": rng.integers(0, 9, 50).astype(np.float64)}, ["k", "y"]),
    }
    store = InMemoryMaterializationStore()
    p1, s1 = _carry(v1, sources)
    ExecutionPlan(p1, s1, plane="torch", device="cpu").run(store=store, materialize=True)
    p2, s2 = _carry(v2, sources)
    res = ExecutionPlan(p2, s2, plane="torch", device="cpu").run(
        store=store, serve_from_store=True)
    assert res.reused_ops == ("j",)
    assert res.stats.ops_executed == 2  # f and sink
    want = RefPlan(v2, sources).run().results["sink"]
    got = res.results["sink"]
    assert ref_identical(want, RTable(got.cols, got.order))


def test_intermediates_freed_like_reference():
    dag = _linear()
    sources = _sources_for(dag)
    pdag, psrc = _carry(dag, sources)
    got = ExecutionPlan(pdag, psrc, plane="torch", device="cpu").run()
    want = RefPlan(dag, sources).run()
    assert got.stats.peak_live_tables == want.stats.peak_live_tables <= 3
    assert got.stats.freed_tables == want.stats.freed_tables


def test_unbound_source_raises():
    dag = _linear(2)
    pdag, _ = _carry(dag, {})
    with pytest.raises(KeyError, match="unbound source"):
        ExecutionPlan(pdag, {}, plane="torch", device="cpu").run()


def _table(seed, n=40):
    rng = np.random.default_rng(seed)
    return Table({"a": rng.uniform(-1, 1, n), "k": rng.integers(0, 5, n),
                  "s": np.array([f"w{i % 3}" for i in range(n)], dtype=object)},
                 ["a", "k", "s"])


def test_disk_store_round_trip_and_dedup(tmp_path):
    store = DiskMaterializationStore(str(tmp_path))
    t = _table(0)
    assert store.put("key1", t, elapsed=0.5)
    assert not store.put("key2", _table(0))  # same bytes: deduplicated
    back = DiskMaterializationStore(str(tmp_path)).get("key1")  # a fresh index
    assert back is not None and back.order == t.order
    assert table_digest(back) == table_digest(t)
    assert store.recorded_cost("key1") == 0.5
    assert store.stats()["objects"] == 1 and len(store) == 2


def test_disk_store_corruption_reads_as_miss(tmp_path):
    store = DiskMaterializationStore(str(tmp_path))
    t = _table(1)
    store.put("k", t)
    payload = tmp_path / "objects" / f"{table_digest(t)}.npz"
    with open(payload, "r+b") as f:
        f.truncate(max(1, os.path.getsize(payload) // 3))
    assert store.get("k") is None
    assert store.corrupt_entries_skipped == 1 and "k" not in store
    (tmp_path / "keys" / "bad.json").write_text("{not json")
    assert DiskMaterializationStore(str(tmp_path)).corrupt_entries_skipped == 1


@pytest.mark.parametrize("flavor", ["memory", "disk"])
def test_store_byte_budget_lru_and_pins(flavor, tmp_path):
    tables = [_table(i) for i in range(4)]
    nbytes = sum(t.cols[c].nbytes for t in tables[:1] for c in ("a", "k"))
    budget = int(nbytes * 2.5)
    store = (InMemoryMaterializationStore(budget) if flavor == "memory"
             else DiskMaterializationStore(str(tmp_path), budget))
    store.put("t0", tables[0])
    pinned = store.pin(["t0", "missing"])
    assert pinned == ("t0",)
    for i in (1, 2, 3):
        store.put(f"t{i}", tables[i])
    assert "t0" in store  # pinned: survives the budget
    assert "t1" not in store and store.evictions >= 1
    store.unpin(pinned)
    store.put("t1", tables[1])
    assert "t0" not in store  # unpinned and stalest: evicted
