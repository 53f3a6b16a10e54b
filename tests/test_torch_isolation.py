"""The port stands alone: no JAX, nothing of the reference package, and no
quiet fallback to the host when CUDA was asked for.

This file imports neither JAX nor the reference package, so its ``cuda``
test runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_isolation.py
"""
import ast
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
        "import sys, repro_torch, repro_torch.carry, repro_torch.core.serialize\n"
        "import repro_torch.engine.plane.torch_plane, repro_torch.kernels.relational\n"
        "import repro_torch.configs, repro_torch.models.registry, repro_torch.serve.decode\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ssd_scan, repro_torch.models.ssm\n"
        "import repro_torch.api, repro_torch.core.verifier, repro_torch.core.ev\n"
        "repro_torch.configs.get_arch('llama3-8b')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


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
