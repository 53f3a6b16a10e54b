"""The torch plane (on the CPU, through the kernel's plain version) against
the reference package's numpy plane.

Every scenario of ``tests/test_plane.py`` is carried across with
``repro_torch.carry.from_reference``: the DAG is built with the reference
package, encoded with its ``dag_to_dict``, and run on the same numpy
sources by both packages.  Sinks must be ``tables_identical`` (bit-level,
NaN == NaN) under the reference package's own comparison.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.api.serialize import dag_to_dict, encode_value
from repro.core import dag as D
from repro.core.dag import DataflowDAG, Link, Operator
from repro.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq
from repro.engine import Table as RTable
from repro.engine import execute as ref_execute
from repro.engine import tables_identical as ref_identical
from repro.engine.canon import column_codes as ref_column_codes
from repro.engine.canon import combine_codes as ref_combine_codes
from repro.engine.ops_impl import _stable_desc_fix as ref_desc_fix
from repro.engine.ops_impl import eval_pred as ref_eval_pred
from repro.service.synthetic import make_chain
from repro_torch.carry import from_reference
from repro_torch.api.serialize import decode_value
from repro_torch.engine import ExecutionPlan, PlaneError, available_planes, get_plane
from repro_torch.engine import execute as port_execute
from repro_torch.engine.canon import column_codes, combine_codes, run_bounds
from repro_torch.engine.ops_impl import _stable_desc_fix
from repro_torch.engine.plane.torch_plane import TorchPlane
from repro_torch.kernels import relational as R


def _sources_for(version, seed=0, n=120):
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


def _as_ref(t):
    return RTable(t.cols, t.order)


def _run_torch(dag, sources):
    pdag, psrc = _carry(dag, sources)
    return port_execute(pdag, psrc, plane="torch", device="cpu")


def _assert_planes_identical(dag, sources):
    ref = ref_execute(dag, sources, plane="numpy")
    got = _run_torch(dag, sources)
    assert set(ref) == set(got)
    for s in ref:
        assert ref_identical(ref[s], _as_ref(got[s])), f"sink {s} differs"
    return got


def _pipeline(*ops, schema=("a", "b", "c"), sem=D.BAG):
    all_ops = [Operator.make("src", D.SOURCE, schema=schema)]
    links = []
    prev = "src"
    for op in ops:
        all_ops.append(op)
        links.append(Link(prev, op.id))
        prev = op.id
    all_ops.append(Operator.make("sink", D.SINK, semantics=sem))
    links.append(Link(prev, "sink"))
    return DataflowDAG(all_ops, links)


def _join_dag(how, schema_l=("k", "x"), schema_r=("k", "y"), on=(("k", "k"),)):
    ops = [
        Operator.make("l", D.SOURCE, schema=schema_l),
        Operator.make("r", D.SOURCE, schema=schema_r),
        Operator.make("j", D.JOIN, on=on, how=how),
        Operator.make("sink", D.SINK, semantics=D.ORDERED),
    ]
    links = [Link("l", "j", 0), Link("r", "j", 1), Link("j", "sink")]
    return DataflowDAG(ops, links)


# ---------------------------------------------------------------------------
# the port's registry
# ---------------------------------------------------------------------------


def test_registry_lists_numpy_and_torch_only():
    assert available_planes() == ["numpy", "torch"]
    assert get_plane("numpy").name == "numpy"
    plane = get_plane("torch", device="cpu")
    assert plane.name == "torch" and plane is get_plane("torch", device="cpu")


def test_get_plane_unknown_raises():
    with pytest.raises(PlaneError, match="numpy"):
        get_plane("jax")


def test_exec_stats_accounting():
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.cmp("a", "<=", 3)),
        Operator.make("di", D.DISTINCT),
    )
    rng = np.random.default_rng(0)
    sources = {
        "src": RTable(
            {c: rng.integers(0, 5, 50).astype(np.float64) for c in "abc"},
            ["a", "b", "c"],
        )
    }
    pdag, psrc = _carry(dag, sources)
    res = ExecutionPlan(pdag, psrc, plane="numpy").run()
    assert res.stats.plane == "numpy" and res.stats.ops_lowered == 0
    res = ExecutionPlan(pdag, psrc, plane="torch", device="cpu").run()
    assert res.stats.plane == "torch"
    assert res.stats.ops_lowered >= 2  # filter + distinct at minimum


# ---------------------------------------------------------------------------
# differential identity: seeded chains, all sink semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_seeded_chain_differential(seed):
    rng = np.random.default_rng(seed)
    n_versions = int(rng.integers(2, 5))
    heavy = bool(seed % 2)
    for version in make_chain(n_versions, heavy=heavy):
        _assert_planes_identical(version, _sources_for(version, seed=seed))


@pytest.mark.parametrize("sem", [D.SET, D.BAG, D.ORDERED])
def test_differential_all_sink_semantics(sem):
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.cmp("a", "<=", 4)),
        Operator.make("di", D.DISTINCT),
        Operator.make("so", D.SORT, keys=(("a", True), ("b", True))),
        sem=sem,
    )
    _assert_planes_identical(dag, _sources_for(dag, seed=len(sem)))


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------


def test_empty_tables_all_ops():
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.cmp("a", "<", 1)),
        Operator.make(
            "p", D.PROJECT,
            cols=(("a", "a"), ("s", LinExpr.make({"a": 2, "b": 1}, -1))),
        ),
        Operator.make("ag", D.AGGREGATE, group_by=("a",),
                      aggs=(("sum", "s", "ss"), ("count", "*", "n"))),
        Operator.make("so", D.SORT, keys=(("ss", True), ("a", True))),
        sem=D.ORDERED,
    )
    empty = {"src": RTable({c: np.array([]) for c in "abc"}, ["a", "b", "c"])}
    _assert_planes_identical(dag, empty)
    for how in ("inner", "left_outer"):
        _assert_planes_identical(_join_dag(how), {
            "l": RTable({"k": np.array([]), "x": np.array([])}, ["k", "x"]),
            "r": RTable({"k": np.array([]), "y": np.array([])}, ["k", "y"]),
        })


def test_left_outer_all_unmatched():
    sources = {
        "l": RTable({"k": np.arange(5.0), "x": np.arange(5.0)}, ["k", "x"]),
        "r": RTable({"k": np.arange(100.0, 103.0), "y": np.arange(3.0)}, ["k", "y"]),
    }
    out = _assert_planes_identical(_join_dag("left_outer"), sources)["sink"]
    assert len(out) == 5 and np.isnan(out.cols["y"]).all()


def test_duplicate_key_join_blowup():
    rng = np.random.default_rng(7)
    sources = {
        "l": RTable({"k": np.repeat([1.0, 2.0], 20),
                     "x": rng.integers(0, 9, 40).astype(np.float64)}, ["k", "x"]),
        "r": RTable({"k": np.repeat([2.0, 3.0], 20),
                     "y": rng.integers(0, 9, 40).astype(np.float64)}, ["k", "y"]),
    }
    for how in ("inner", "left_outer"):
        out = _assert_planes_identical(_join_dag(how), sources)["sink"]
    assert len(_run_torch(_join_dag("inner"), sources)["sink"]) == 20 * 20
    assert len(out) == 20 * 20 + 20


def test_nan_and_negative_zero_join_keys():
    # NaN keys never match (fresh dict key per row); -0.0 joins +0.0
    sources = {
        "l": RTable({"k": np.array([np.nan, -0.0, 1.0, np.nan]),
                     "x": np.arange(4.0)}, ["k", "x"]),
        "r": RTable({"k": np.array([np.nan, 0.0, 1.0]),
                     "y": np.arange(3.0)}, ["k", "y"]),
    }
    for how in ("inner", "left_outer"):
        _assert_planes_identical(_join_dag(how), sources)


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_sparse_code_join_takes_device_probe(how):
    """Four high-cardinality key columns push the combined code range past
    the dense-lookup threshold: the plane takes the torch sort/searchsorted
    probe, which must agree with the reference."""
    rng = np.random.default_rng(9)
    n = 64
    cols = {f"k{i}": rng.permutation(n).astype(np.float64) for i in range(4)}
    lx = dict(cols, x=np.arange(float(n)))
    ridx = rng.permutation(n)[: n // 2]
    ry = dict({f"k{i}": cols[f"k{i}"][ridx] for i in range(4)}, y=np.arange(float(n // 2)))
    on = tuple((f"k{i}", f"k{i}") for i in range(4))
    dag = _join_dag(how, schema_l=tuple(lx), schema_r=tuple(ry), on=on)
    plane = get_plane("torch", device="cpu")
    before = plane.device_probes
    _assert_planes_identical(dag, {"l": RTable(lx, list(lx)), "r": RTable(ry, list(ry))})
    assert plane.device_probes == before + 1


def test_single_group_aggregate():
    dag = _pipeline(
        Operator.make("ag", D.AGGREGATE, group_by=("a",),
                      aggs=(("sum", "b", "sb"), ("avg", "c", "ac"),
                            ("min", "b", "mb"), ("max", "c", "xc"),
                            ("count", "*", "n"))),
        sem=D.ORDERED,
    )
    rng = np.random.default_rng(3)
    sources = {"src": RTable(
        {"a": np.full(64, 2.0),
         "b": rng.integers(-5, 5, 64).astype(np.float64),
         "c": rng.integers(-5, 5, 64).astype(np.float64)},
        ["a", "b", "c"],
    )}
    _assert_planes_identical(dag, sources)
    dag2 = _pipeline(
        Operator.make("ag", D.AGGREGATE, group_by=(),
                      aggs=(("sum", "b", "sb"), ("count", "*", "n"))),
        sem=D.ORDERED,
    )
    _assert_planes_identical(dag2, sources)


def test_left_outer_pad_upcasts_int_to_float64():
    sources = {
        "l": RTable({"k": np.arange(4.0), "x": np.arange(4.0)}, ["k", "x"]),
        "r": RTable({"k": np.array([0.0, 2.0]),
                     "y": np.array([10, 20], dtype=np.int64)}, ["k", "y"]),
    }
    out = _assert_planes_identical(_join_dag("left_outer"), sources)["sink"]
    assert out.cols["y"].dtype == np.float64


def test_object_column_routes_per_op():
    """A plan mixing object and numeric columns executes mixed-plane: the
    torch plane lowers what it can and routes the rest to the reference."""
    obj = np.array(["u", "v", "w", "u", "v", "w"], dtype=object)
    src = RTable({"a": np.array([3.0, 1.0, 2.0, 3.0, 1.0, 2.0]), "t": obj}, ["a", "t"])
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.cmp("a", "<=", 2)),
        Operator.make("di", D.DISTINCT),
        schema=("a", "t"),
        sem=D.BAG,
    )
    _assert_planes_identical(dag, {"src": src})
    pdag, psrc = _carry(dag, {"src": src})
    plane = get_plane("torch", device="cpu")
    assert plane.lowers(pdag.ops["f"], [psrc["src"]])
    assert not plane.lowers(pdag.ops["di"], [psrc["src"]])


def test_string_and_nonlinear_atoms_are_host_masks():
    obj = np.array(["u", "v", "w", "v", "u", "v"], dtype=object)
    src = RTable({"a": np.array([3.0, -1.0, 2.0, 0.5, 1.0, -2.0]),
                  "b": np.array([1.0, -2.0, 0.0, 4.0, -1.0, 2.0]), "t": obj},
                 ["a", "b", "t"])
    pred = Pred.or_(
        Pred.and_(Pred.cmp("a", "<=", 2), Pred.of(StrEq("t", "v"))),
        Pred.of(NonLinearAtom("prod_pos", ("a", "b"))),
    )
    dag = _pipeline(Operator.make("f", D.FILTER, pred=pred), schema=("a", "b", "t"))
    _assert_planes_identical(dag, {"src": src})


def _wide_table(n_cols, n, seed):
    rng = np.random.default_rng(seed)
    names = [f"a{i}" for i in range(n_cols)]
    cols = {c: rng.uniform(-4, 4, n) for c in names}
    cols["t"] = rng.choice(np.array(["u", "v", "w"], dtype=object), n)
    return RTable(cols, names + ["t"]), names


def test_wide_filter_and_projection_lower_with_no_plan_cap():
    """17 columns, 40 atoms (680 products), 10 host masks and 40 projected
    values: the kernel's plan has no fixed capacity, so both operators
    lower (none is routed to the reference) and match the reference."""
    src, names = _wide_table(17, 300, seed=21)
    rng = np.random.default_rng(22)

    def expr():
        return LinExpr.make({c: Fraction(int(rng.integers(-9, 10)) or 1, int(rng.integers(1, 5)))
                             for c in names}, Fraction(int(rng.integers(-3, 4)), 2))

    atoms = [Pred.of(LinCmp(expr(), ("<=", "<", "!=")[i % 3])) for i in range(40)]
    hosts = [Pred.of(StrEq("t", "uvw"[i % 3])) for i in range(10)]
    pred = Pred.or_(*[Pred.and_(*atoms[i:i + 4], hosts[i // 4]) for i in range(0, 40, 4)])
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=pred),
        Operator.make("p", D.PROJECT, cols=tuple((f"v{i}", expr()) for i in range(40))),
        schema=tuple(names) + ("t",),
    )
    _assert_planes_identical(dag, {"src": src})
    pdag, psrc = _carry(dag, {"src": src})
    plane = TorchPlane(device="cpu")
    assert plane.lowers(pdag.ops["f"], [psrc["src"]])
    filtered = plane.execute_op(pdag.ops["f"], [psrc["src"]])
    assert plane.lowers(pdag.ops["p"], [filtered])
    program = plane._pred_plan(pdag.ops["f"].get("pred")).program
    assert (program.n_cols, len(program.terms), program.n_hosts) == (17, 40, 10)
    assert len(program.prods) == 680


def test_deep_predicate_lowers_in_a_shallow_stack():
    """An and/or chain nested 100 deep evaluates its deepest child first,
    so its postfix program needs a stack of 2, not 101."""
    src, names = _wide_table(3, 200, seed=23)
    pred = Pred.cmp("a0", "<=", 0)
    for i in range(100):
        atom = Pred.of(LinCmp(LinExpr.make({names[i % 3]: 1, names[(i + 1) % 3]: -1},
                                           Fraction(i - 50, 25)), "<="))
        pred = Pred.and_(atom, pred) if i % 2 else Pred.or_(atom, pred)
    dag = _pipeline(Operator.make("f", D.FILTER, pred=pred), schema=tuple(names) + ("t",))
    _assert_planes_identical(dag, {"src": src})
    pdag, psrc = _carry(dag, {"src": src})
    plane = TorchPlane(device="cpu")
    assert plane.lowers(pdag.ops["f"], [psrc["src"]])
    assert plane._pred_plan(pdag.ops["f"].get("pred")).program.depth() == 2


def test_adversarial_float_filter_and_project():
    """Fractional coefficients + near-boundary values + NaN/inf: the
    relational program must agree with the scalar reference where an
    FMA-contracted evaluation would flip a comparison."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([
        rng.uniform(-1e6, 1e6, 2000),
        rng.integers(-3, 4, 500).astype(np.float64) / 3.0,
        np.array([0.1, 0.2, 0.3, 1e-9, -1e-9, 1e15, -1e15, np.nan, np.inf, -np.inf, -0.0]),
    ])
    rng.shuffle(vals)
    src = RTable({"a": vals, "b": np.roll(vals, 7), "c": np.roll(vals, 13)}, ["a", "b", "c"])
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.of(LinCmp(
            LinExpr.make({"a": Fraction(5, 2), "b": Fraction(-7, 4)},
                         Fraction(1, 3)), "<="))),
        Operator.make("p", D.PROJECT, cols=(
            ("a", "a"),
            ("s", LinExpr.make({"a": Fraction(1, 3), "b": 2,
                                "c": Fraction(-1, 7)}, -0.5)),
        )),
        sem=D.BAG,
    )
    with np.errstate(all="ignore"):
        got = _assert_planes_identical(dag, {"src": src})["sink"]
        want = ref_execute(dag, {"src": src})["sink"]
    assert got.cols["s"].tobytes() == want.cols["s"].tobytes()  # NaN bits too


def test_kernel_reads_only_float64_and_int64(monkeypatch):
    """bool, int32 and float32 columns reach the kernel cast to float64 on
    the host, as the reference's ``astype(np.float64)``; int64 stays int64
    and is converted inside the kernel."""
    seen = []

    def checked(program, cols, hosts=()):
        seen.extend(c.dtype for c in cols)
        return R.relational_reference(program, cols, hosts)

    monkeypatch.setattr(R, "relational", checked)
    rng = np.random.default_rng(8)
    n = 50
    src = RTable({"a": rng.random(n) < 0.5,
                  "b": rng.integers(-9, 9, n).astype(np.int32),
                  "c": rng.integers(-9, 9, n).astype(np.int64),
                  "d": rng.uniform(-2, 2, n).astype(np.float32)}, ["a", "b", "c", "d"])
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.of(LinCmp(
            LinExpr.make({"a": 2, "b": Fraction(1, 3), "d": -1}, -1), "<="))),
        Operator.make("p", D.PROJECT, cols=(
            ("s", LinExpr.make({"a": 1, "c": Fraction(1, 7), "d": 3}, 0.5)), ("c", "c"))),
        schema=("a", "b", "c", "d"),
    )
    plane = TorchPlane(device="cpu")
    pdag, psrc = _carry(dag, {"src": src})
    got = psrc["src"]
    for op_id in ("f", "p"):
        got = plane.execute_op(pdag.ops[op_id], [got])
    want = ref_execute(dag, {"src": src})["sink"]
    assert ref_identical(want, RTable(got.cols, got.order))
    assert set(seen) == {torch.float64, torch.int64}


def test_sort_descending_and_mixed_directions():
    rng = np.random.default_rng(5)
    src = RTable(
        {"a": rng.integers(0, 4, 200).astype(np.float64),
         "b": rng.integers(0, 4, 200).astype(np.float64),
         "c": np.arange(200.0)},
        ["a", "b", "c"],
    )
    for keys in ((("a", True), ("b", True)),
                 (("a", False), ("b", True)),
                 (("a", True), ("b", False))):
        dag = _pipeline(Operator.make("so", D.SORT, keys=keys), sem=D.ORDERED)
        _assert_planes_identical(dag, {"src": src})


def test_pred_mask_matches_eval_pred():
    rng = np.random.default_rng(4)
    cols = {c: rng.uniform(-3, 3, 300) for c in "abc"}
    cols["a"][::17] = np.nan
    pred = Pred.or_(Pred.cmp("a", "<=", 1), Pred.not_(Pred.col_cmp("b", "<", "c")))
    plane = get_plane("torch", device="cpu")
    pt = from_reference({"ops": [], "links": []}, {"t": cols})[1]["t"]
    got = plane.pred_mask(decode_value(encode_value(pred)), pt)
    assert np.array_equal(got, ref_eval_pred(pred, RTable(cols, list(cols))))


def test_exactness_probe_mismatch_raises(monkeypatch):
    def off_by_one(program, cols, hosts=()):
        out = R.relational_reference(program, cols, hosts)
        return ~out if program.tree else out

    monkeypatch.setattr(R, "relational", off_by_one)
    plane = TorchPlane(device="cpu")
    dag = _pipeline(Operator.make("f", D.FILTER, pred=Pred.cmp("a", "<=", 3)))
    pdag, psrc = _carry(dag, _sources_for(dag))
    with pytest.raises(PlaneError, match="exactness probe"):
        plane.execute_op(pdag.ops["f"], [psrc["src"]])


# ---------------------------------------------------------------------------
# canon: the port's copy against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_canon_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 150))
    vals = rng.integers(-3, 4, n).astype(np.float64)
    vals[rng.random(n) < 0.1] = np.nan
    vals[rng.random(n) < 0.1] = -0.0
    vals[rng.random(n) < 0.1] += 1e-10
    for nan_distinct in (True, False):
        assert np.array_equal(column_codes(vals, nan_distinct=nan_distinct),
                              ref_column_codes(vals, nan_distinct=nan_distinct))
    big = np.int64(1) << 40
    code_cols = [rng.integers(0, 5, n).astype(np.int64) * (big // 5) for _ in range(3)]
    assert np.array_equal(combine_codes(code_cols), ref_combine_codes(code_cols))
    order_ = np.argsort(vals, kind="stable")
    assert np.array_equal(_stable_desc_fix(vals[order_], order_),
                          ref_desc_fix(vals[order_], order_))
    run_id, starts, ends = run_bounds(np.sort(column_codes(vals, nan_distinct=True)))
    assert len(starts) == len(ends) == (int(run_id[-1]) + 1 if n else 0)


def test_kernel_launches_are_counted_by_what_asked_for_them(monkeypatch):
    """The plane files each relational launch under its use: the one-time
    exactness probe (a mask and a projection), FILTER, PROJECT and the
    delta engine's ``pred_mask``; the sum is the kernel's own count."""
    def counting(program, cols, hosts=()):
        counting.launches += 1
        return R.relational_reference(program, cols, hosts)

    counting.launches = 0
    monkeypatch.setattr(R, "relational", counting)
    rng = np.random.default_rng(9)
    src = RTable({"a": rng.uniform(-5, 5, 40), "b": rng.uniform(-5, 5, 40)}, ["a", "b"])
    dag = _pipeline(
        Operator.make("f", D.FILTER, pred=Pred.cmp("a", ">", 0)),
        Operator.make("p", D.PROJECT, cols=(("s", LinExpr.make({"a": 2, "b": -1}, 1)),)),
        schema=("a", "b"),
    )
    plane = TorchPlane(device="cpu")
    pdag, psrc = _carry(dag, {"src": src})
    got = psrc["src"]
    for _ in range(2):
        for op_id in ("f", "p"):
            got = plane.execute_op(pdag.ops[op_id], [psrc["src"] if op_id == "f" else got])
    plane.pred_mask(pdag.ops["f"].get("pred"), psrc["src"])
    assert plane.kernel_launches == {"probe": 2, D.FILTER: 2, D.PROJECT: 2, "pred_mask": 1}
    assert sum(plane.kernel_launches.values()) == counting.launches
