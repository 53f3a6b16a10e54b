"""The relational CUDA kernel on the card, by route, against its plain
version and against the numpy reference (``eval_pred`` / ``eval_linexpr``).

This file imports neither JAX nor the reference package, so its ``cuda``
tests run on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_relational_cuda.py

No tolerance: masks must be equal, and values equal bit for bit to numpy,
NaN bits included, except in rows where an add had two NaN operands with
different bits (numpy's own payload there is left open: NaN in both), and
to the plain version except for NaN payloads.  Both routes (``R.ROUTES``)
are launched: the adversarial programs in the launch's 1 KiB of parameters,
the wide, deep and 240-atom filters, the 40-value projection and a
projection over more columns than a block's shared memory holds through
device memory.
"""
import importlib.util
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core.predicates import LinCmp, LinExpr, Pred
from repro_torch.engine.ops_impl import eval_linexpr, eval_pred
from repro_torch.engine.plane.torch_plane import TorchPlane
from repro_torch.engine.table import Table
from repro_torch.kernels import relational as R

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZES = (0, 1, 7, 1023, 1025, 4097, 1_000_000)


def _chip_smoke():
    """chip_smoke.py as a module, for the helpers that make its cases (it
    imports the port only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()


@pytest.fixture
def plane():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs these on the card")
    return TorchPlane(device="cpu")  # compiles the plans; the tensors go to the card here


def _check_mask(program, cols, hosts, want, what):
    kern = R.relational(program, cols, hosts)
    assert kern.dtype == torch.bool and kern.shape == want.shape, what
    assert torch.equal(kern, R.relational_reference(program, cols, hosts)), what
    assert np.array_equal(kern.cpu().numpy(), want), what


def _check_values(program, cols, items, exprs, t, what):
    kern = R.relational(program, cols)
    plain = R.relational_reference(program, cols)
    for name, kind, ti in items:
        if kind != "lin":
            continue
        free = SMOKE._two_nan_rows(exprs[name], t)
        assert SMOKE._bits_equal(kern[ti].cpu().numpy(), eval_linexpr(exprs[name], t), free), \
            f"{what} {name}"
        assert SMOKE._values_match_plain(kern[ti], plain[ti]), f"{what} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", SIZES)
def test_param_route_matches_plain_and_numpy(plane, n, offset):
    np.seterr(all="ignore")
    preds, proj = SMOKE._cases()
    cols = SMOKE._adversarial(n, seed=n + offset)
    t = Table(cols, ["a", "b", "c"])
    before = dict(R.relational.launches_by_instance)
    for i, pred in enumerate(preds):
        plan = plane._compile_pred(pred)
        assert R.route(plan.program) == "param"
        hosts = [SMOKE._on_card(eval_pred(Pred.of(a), t), offset) for a in plan.host_atoms]
        dcols = [SMOKE._on_card(t.cols[c], offset) for c in plan.columns]
        _check_mask(plan.program, dcols, hosts, eval_pred(pred, t), f"filter {i} n={n}")
    pplan = plane._compile_proj(proj)
    dcols = [SMOKE._on_card(t.cols[c], offset) for c in pplan.columns]
    _check_values(pplan.program, dcols, pplan.items, dict(proj), t, f"project n={n}")
    launched = R.relational.launches_by_instance["param"] - before["param"]
    assert launched == (len(preds) + 1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1025, 4097, 200_000])
def test_large_programs_through_device_plans_match_plain_and_numpy(plane, n):
    np.seterr(all="ignore")
    names = [f"a{i}" for i in range(17)]
    preds, proj = SMOKE._large_programs(names)
    rng = np.random.default_rng(n + 7)
    cols = {c: rng.uniform(-4, 4, n) for c in names}
    cols["a16"] = rng.integers(-4, 5, n, dtype=np.int64)
    for c in names[:4]:
        cols[c][rng.integers(0, n, n // 16 + 1)] = rng.choice(
            np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-12]), n // 16 + 1)
    cols["t"] = rng.choice(np.array(["u", "v", "w"], dtype=object), n)
    t = Table(cols, names + ["t"])
    for name, pred in preds.items():
        plan = plane._compile_pred(pred)
        assert R.route(plan.program) == "device"
        before = R.relational.launches_by_instance["device"]
        hosts = [SMOKE._on_card(eval_pred(Pred.of(a), t), 0) for a in plan.host_atoms]
        dcols = [SMOKE._on_card(t.cols[c], n % 2) for c in plan.columns]
        _check_mask(plan.program, dcols, hosts, eval_pred(pred, t), f"{name} n={n}")
        assert R.relational.launches_by_instance["device"] == before + 1
    pplan = plane._compile_proj(proj)
    assert R.route(pplan.program) == "device"
    dcols = [SMOKE._on_card(t.cols[c], 0) for c in pplan.columns]
    _check_values(pplan.program, dcols, pplan.items, dict(proj), t, f"40 values n={n}")


@pytest.mark.cuda
def test_more_columns_than_shared_memory_holds(plane):
    """A projection over 4,000 columns: its plan goes through device memory,
    and the columns beyond what one block's ring holds are read in place."""
    np.seterr(all="ignore")
    n, k = 1025, 4000
    rng = np.random.default_rng(5)
    names = [f"c{i}" for i in range(k)]
    cols = {c: rng.uniform(-1, 1, n) for c in names}
    cols[names[-1]] = rng.integers(-(2**60), 2**60, n, dtype=np.int64)
    cols[names[-2]][::7] = np.nan
    expr = LinExpr.make({c: Fraction(int(rng.integers(1, 9)), 4) for c in names}, Fraction(1, 3))
    proj = (("v", expr), ("w", LinExpr.make({names[0]: 2, names[-1]: -1}, 0)))
    t = Table(cols, names)
    pplan = plane._compile_proj(proj)
    assert R.route(pplan.program) == "device"
    dcols = [SMOKE._on_card(t.cols[c], 0) for c in pplan.columns]
    _check_values(pplan.program, dcols, pplan.items, dict(proj), t, "4000 columns")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_int64_beyond_2_53_specials_and_bands(plane, offset):
    np.seterr(all="ignore")
    special = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-12, -1e-12, np.nextafter(1e-12, 1.0),
               np.nextafter(-1e-12, -1.0), np.nextafter(1e-12, 0.0), 5e-13, -5e-13]
    a = np.array(special * 4)
    b = np.repeat(np.array(special[:4]), len(special))
    c = np.array([2**53 + 1, 2**53 + 3, -(2**53) - 1, 2**62 + 1, -(2**62) - 3, 7, -7, 0, 1, -1,
                  2**63 - 1, -(2**63)] * 4, dtype=np.int64)
    t = Table({"a": a, "b": b, "c": c}, ["a", "b", "c"])
    exprs = {"x": LinExpr.make({"a": 1}, 0), "y": LinExpr.make({"a": 1, "b": -1}, 0),
             "z": LinExpr.make({"c": Fraction(1, 2), "a": 1}, Fraction(1, 4)),
             "u": LinExpr.make({"a": 1}, Fraction(-1, 10**12))}
    for name, e in exprs.items():
        for op in ("<=", "<", "==", "!="):
            pred = Pred.of(LinCmp(e, op))
            plan = plane._compile_pred(pred)
            dcols = [SMOKE._on_card(t.cols[col], offset) for col in plan.columns]
            _check_mask(plan.program, dcols, [], eval_pred(pred, t), f"{name} {op}")
    pplan = plane._compile_proj(tuple(exprs.items()))
    dcols = [SMOKE._on_card(t.cols[col], offset) for col in pplan.columns]
    _check_values(pplan.program, dcols, pplan.items, exprs, t, "specials")
