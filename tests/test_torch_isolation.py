"""The port stands alone: no JAX, nothing of the reference package or of
the repository's benchmarks (in the package, its example twins
``examples/torch_*.py`` and ``chip_smoke.py``), and no quiet fallback to
the host when CUDA was asked for.

This file imports neither JAX nor the reference package, so its ``cuda``
tests run on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_isolation.py
"""
import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core import dag as D
from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred
from repro_torch.engine import ExecutionPlan, PlaneError, Table, execute, get_plane
from repro_torch.engine import plane as plane_registry
from repro_torch.engine.plane import torch_plane
from repro_torch.engine.ops_impl import eval_pred
from repro_torch.engine.plane.torch_plane import TorchPlane
from repro_torch.kernels import relational as R

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, repro_torch, repro_torch.carry, repro_torch.api.serialize\n"
        "import repro_torch.data, repro_torch.data.pipeline, repro_torch.models.moe\n"
        "import repro_torch.models.encdec, repro_torch.models.vlm\n"
        "import repro_torch.engine.plane.torch_plane, repro_torch.kernels.relational\n"
        "import repro_torch.configs, repro_torch.models.registry, repro_torch.serve.decode\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ssd_scan, repro_torch.models.ssm\n"
        "import repro_torch.api, repro_torch.core.verifier, repro_torch.core.ev\n"
        "import repro_torch.core.frontier, repro_torch.core.delta, repro_torch.engine.delta\n"
        "import repro_torch.service, repro_torch.service.synthetic, repro_torch.reuse\n"
        "import repro_torch.core.ev.fx_ev, repro_torch.core.ev.torch_bodies\n"
        "import repro_torch.learn, repro_torch.learn.train, repro_torch.workload\n"
        "import repro_torch.workload.workloads, repro_torch.workload.replay\n"
        "import repro_torch.service.server, repro_torch.service.fleet\n"
        "import repro_torch.service.remote, repro_torch.service.remote.filetier\n"
        "import repro_torch.train, repro_torch.train.loop, repro_torch.checkpoint\n"
        "import repro_torch.distributed, repro_torch.distributed.fault\n"
        "repro_torch.configs.get_arch('llama3-8b')\n"
        "repro_torch.api.VeerConfig(guidance='model').build()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', 'benchmarks')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.', 'benchmarks.')))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip() == ""


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_of_the_port_imports_jax_or_the_reference():
    twins = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(twins) == 6
    files = sorted(PORT.rglob("*.py")) + twins + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), f"{path}: imports {mod}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(plane_registry, "_INSTANCES", {})  # no memoized plane


def test_cuda_without_cuda_raises(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(PlaneError, match="device='cpu'"):
        TorchPlane()
    with pytest.raises(PlaneError):
        TorchPlane(device="cuda:0")
    with pytest.raises(PlaneError):
        get_plane("torch", device="cuda:3")


@pytest.mark.parametrize("device", ["meta", "not-a-device"])
def test_unsupported_device_raises(device):
    with pytest.raises(PlaneError):
        torch_plane.resolve_device(device)


def test_execute_defaults_to_cuda(monkeypatch):
    """The entry points run on CUDA unless the CPU is asked for: with no
    CUDA, the default refuses instead of carrying on on the host."""
    _no_cuda(monkeypatch)
    dag = D.DataflowDAG(
        [D.Operator.make("s", D.SOURCE, schema=("a",)), D.Operator.make("k", D.SINK)],
        [D.Link("s", "k")],
    )
    sources = {"s": Table({"a": [1.0, 2.0]}, ["a"])}
    with pytest.raises(PlaneError, match="device='cpu'"):
        execute(dag, sources)
    with pytest.raises(PlaneError):
        ExecutionPlan(dag, sources)
    with pytest.raises(PlaneError):
        execute(dag, sources, plane="torch")
    assert execute(dag, sources, device="cpu")["k"].n == 2
    assert ExecutionPlan(dag, sources, device="cpu").plane.name == "torch"
    assert execute(dag, sources, plane="numpy")["k"].n == 2


@pytest.mark.parametrize("name", ["quickstart", "chain_session", "verification_service",
                                  "iterative_analytics", "serve_decode", "train_lm"])
def test_example_twins_default_to_cuda(monkeypatch, name):
    """Each twin runs on CUDA unless the CPU is asked for: without CUDA its
    ``main()`` raises before it prints anything."""
    spec = importlib.util.spec_from_file_location(f"_twin_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _no_cuda(monkeypatch)
    with pytest.raises((PlaneError, RuntimeError), match="device='cpu'"):
        mod.main()


def test_chain_session_and_reuse_manager_default_to_cuda(monkeypatch, tmp_path):
    """A session's executing submit, and a reuse manager's submit, run on
    CUDA unless the CPU is asked for: without CUDA the default refuses, and
    the refused submit leaves the session where it was."""
    from repro_torch.engine import InMemoryMaterializationStore
    from repro_torch.reuse import ReuseManager
    from repro_torch.service import VersionChainSession
    from repro_torch.service.synthetic import make_chain

    _no_cuda(monkeypatch)
    v1, v2 = make_chain(2)
    rng = np.random.default_rng(0)
    sources = {sid: Table({c: rng.integers(-2, 7, 50).astype(np.float64) for c in "abc"},
                          list("abc")) for sid in v1.sources}
    session = VersionChainSession(materialization_store=InMemoryMaterializationStore())
    assert session.plane == "torch" and session.device == "cuda"
    with pytest.raises(PlaneError, match="device='cpu'"):
        session.submit(v1, sources=sources)
    assert session.version_count == 0
    assert session.submit(v1) is None  # verifying needs no device
    assert session.submit(v2).verdict is True
    with pytest.raises(PlaneError, match="device='cpu'"):
        ReuseManager(str(tmp_path / "store")).submit(v1, sources)
    on_cpu = VersionChainSession(materialization_store=InMemoryMaterializationStore(),
                                 device="cpu")
    assert on_cpu.submit(v1, sources=sources).exec_stats.plane == "torch"
    assert on_cpu.submit(v2, sources=sources).exec_stats.ops_reused > 0
    assert ReuseManager(str(tmp_path / "cpu"), device="cpu").submit(v1, sources)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The kernel on the card against its plain version on the host: masks
    equal, values equal bit for bit (NaN payloads included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    plane = TorchPlane(device="cpu")
    e1 = LinExpr.make({"a": Fraction(5, 2), "b": Fraction(-7, 4)}, Fraction(1, 3))
    e2 = LinExpr.make({"b": Fraction(1, 3), "c": 2}, Fraction(-1, 2))
    pred = Pred.or_(
        Pred.and_(Pred.of(LinCmp(e1, "<=")), Pred.not_(Pred.of(LinCmp(e2, "==")))),
        Pred.of(NonLinearAtom("prod_pos", ("a", "b"))),
    )
    pplan = plane._compile_pred(pred)
    jplan = plane._compile_proj((("x", e1), ("y", e2)))
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-12, -1e-12])
    for n in (0, 1, 7, 1023, 1025, 100_003):
        rng = np.random.default_rng(n)
        cols = {"a": rng.uniform(-1e6, 1e6, n), "b": rng.uniform(-1e6, 1e6, n),
                "c": rng.integers(-(2**53), 2**53, n, dtype=np.int64)}
        if n:
            cols["a"][rng.integers(0, n, n // 4 + 1)] = rng.choice(special, n // 4 + 1)
        t = Table(cols, ["a", "b", "c"])
        with np.errstate(all="ignore"):
            hosts = [torch.from_numpy(eval_pred(Pred.of(a), t)) for a in pplan.host_atoms]
        dcols = [torch.from_numpy(cols[c]) for c in pplan.columns]
        before = R.relational.launches
        got = R.relational(pplan.program, [x.cuda() for x in dcols], [h.cuda() for h in hosts])
        assert R.relational.launches == before + (1 if n else 0)
        assert torch.equal(got.cpu(), R.relational(pplan.program, dcols, hosts))
        dcols = [torch.from_numpy(cols[c]) for c in jplan.columns]
        got = R.relational(jplan.program, [x.cuda() for x in dcols])
        for g, w in zip(got, R.relational(jplan.program, dcols)):
            assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.cuda
def test_cuda_delta_chain_masks_run_the_kernel():
    """A dominated-filter chain in delta mode on the card: every sink equal
    to the numpy plane's, every successor through the delta tier, and the
    relational kernel launched by the delta runs (their filter masks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    from repro_torch.api import VeerConfig
    from repro_torch.engine import InMemoryMaterializationStore, tables_identical
    from repro_torch.service import VersionChainSession

    def version(th):
        ops = [D.Operator.make("src", D.SOURCE, schema=("a", "b")),
               D.Operator.make("fe", D.FILTER, pred=Pred.cmp("b", "<", th)),
               D.Operator.make("fa", D.FILTER, pred=Pred.cmp("a", ">", 2)),
               D.Operator.make("fb", D.FILTER, pred=Pred.cmp("b", "<", 50)),
               D.Operator.make("sink", D.SINK, semantics=D.BAG)]
        path = [o.id for o in ops]
        return D.DataflowDAG(ops, [D.Link(x, y) for x, y in zip(path, path[1:])])

    rng = np.random.default_rng(0)
    n = 200_000
    sources = {"src": Table({"a": rng.integers(0, 10, n).astype(np.float64),
                             "b": rng.uniform(0, 100, n)}, ["a", "b"])}
    session = VersionChainSession(config=VeerConfig(exec_mode="delta"),
                                  materialization_store=InMemoryMaterializationStore())
    for k, th in enumerate((80.0, 74.0, 90.0)):
        before = R.relational.launches
        report = session.submit(version(th), sources=sources)
        want = execute(version(th), sources, plane="numpy")
        assert all(tables_identical(want[s], report.results[s]) for s in want)
        if k:
            assert report.verdict is True
            assert report.exec_stats.ops_delta > 0
            assert R.relational.launches > before



def _scaled_sum(t):
    """A UDF the CUDA fleet test registers at run time (importable, so a
    forkserver's worker can be sent it)."""
    return t.with_col("s", t.cols["a"] * 3.0 + t.cols["b"])


@pytest.mark.cuda
def test_cuda_fleet_runs_a_udf_registered_at_run_time_and_tokenize_pack(monkeypatch):
    """After the parent used the card, a 2-worker CUDA fleet (workers from a
    forkserver) runs a DAG whose UDF the parent registered at run time and
    the ingestion pipeline's ``tokenize_pack``: no errors, every sink
    identical to the parent's own run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    from repro_torch.api import VeerConfig
    from repro_torch.data import corpus_table, ingestion_pipeline
    from repro_torch.engine import ops_impl, tables_identical
    from repro_torch.service import VerificationFleet, stop_helper_processes

    monkeypatch.setitem(ops_impl.UDF_REGISTRY, "cuda_fleet_scaled_sum", _scaled_sum)
    ops = [D.Operator.make("src", D.SOURCE, schema=("a", "b")),
           D.Operator.make("f", D.FILTER, pred=Pred.cmp("a", ">", 0)),
           D.Operator.make("u", D.UDF, fn="cuda_fleet_scaled_sum", out_schema=("a", "b", "s")),
           D.Operator.make("out", D.SINK, semantics=D.BAG)]
    udf_dag = D.DataflowDAG(ops, [D.Link(x.id, y.id) for x, y in zip(ops, ops[1:])])
    rng = np.random.default_rng(1)
    udf_src = {"src": Table({"a": rng.integers(-5, 9, 100_000).astype(np.float64),
                             "b": rng.uniform(-1, 1, 100_000)}, ["a", "b"])}
    ingest = [ingestion_pipeline(min_quality=0.25, lang=0), ingestion_pipeline(min_quality=0.6, lang=0)]
    ingest_src = {"corpus": corpus_table(20_000)}
    want_udf = execute(udf_dag, udf_src)  # the parent on the card
    want_ingest = [execute(v, ingest_src) for v in ingest]
    assert R.relational.launches > 0
    with VerificationFleet(2, config=VeerConfig(evs=("equitas", "spes", "udp")),
                           device="cuda") as fleet:
        f_udf = fleet.submit("udf", udf_dag, sources=udf_src, timeout=300)
        f_ingest = [fleet.submit("ingest", v, sources=ingest_src, timeout=300) for v in ingest]
        report = fleet.drain()
    assert not report.errors, report.errors
    got = f_udf.result(timeout=300).results
    assert all(tables_identical(want_udf[s], got[s]) for s in want_udf)
    for want, f in zip(want_ingest, f_ingest):
        got = f.result(timeout=300).results
        assert all(tables_identical(want[s], got[s]) for s in want)
    del fleet
    stop_helper_processes()


@pytest.mark.cuda
def test_cuda_fleet_workers_run_the_kernel_after_the_parent_used_the_card():
    """The parent runs the torch plane on the card first (so CUDA is
    initialized here), then a 2-worker fleet on ``device="cuda"``: both
    workers execute, and each reports relational launches of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    from repro_torch.api import VeerConfig
    from repro_torch.engine import tables_identical
    from repro_torch.service import (
        ConsistentHashRing,
        VerificationFleet,
        shard_key,
        stop_helper_processes,
    )
    from repro_torch.service.synthetic import make_chain

    chain = make_chain(3, heavy=True)
    rng = np.random.default_rng(0)
    sources = {sid: Table({c: rng.integers(0, 7, 100_000).astype(np.float64) for c in "abc"},
                          list("abc")) for sid in sorted(chain[0].sources)}
    want = [execute(v, sources) for v in chain]  # the parent on the card
    assert R.relational.launches > 0
    ring = ConsistentHashRing(2)
    clients, shards = [], set()
    for i in range(64):  # one client per shard, so both workers execute
        shard = ring.node(shard_key(f"c{i}", chain[0]))
        if shard not in shards:
            shards.add(shard)
            clients.append(f"c{i}")
    with VerificationFleet(2, config=VeerConfig(evs=("equitas", "spes", "udp")),
                           device="cuda") as fleet:
        futs = {c: [fleet.submit(c, v, sources=sources, timeout=300) for v in chain]
                for c in clients}
        report = fleet.drain()
    assert not report.errors, report.errors
    for fs in futs.values():
        for k, f in enumerate(fs):
            r = f.result(timeout=300)
            assert all(tables_identical(want[k][s], r.results[s]) for s in want[k])
    assert [ws["relational_launches"] > 0 for ws in report.worker_stats] == [True, True]
    del fleet
    stop_helper_processes()  # the forkserver and resource tracker end here
