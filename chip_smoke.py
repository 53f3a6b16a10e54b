#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU, end to end.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

  1. device      CUDA must be available; prints the card's name and power
                 limit as ``nvidia-smi`` gives them.
  2. build       compiles ``src/repro_torch/csrc/relational.cu`` with nvcc.
  3. kernel      the relational kernel against its plain PyTorch version on
                 the card and against the numpy reference, on adversarial
                 inputs (uniform +-1e6, int64, NaN, +-0, +-inf, values on the
                 +-1e-12 bands) at n in {0, 1, 7, 1023, 1025, 1M, 16M};
                 then programs of 17 columns, 240 atoms, 10 host masks,
                 a tree nested 100 deep and 40 projected values.
                 Tolerance: none.  Masks must be equal; values must be equal
                 bit for bit to numpy (NaN bits too, except where an add
                 has two different NaN operands, whose result numpy itself
                 leaves open: NaN in both there), and to the plain version
                 except for NaN payloads (its NaNs are the card's own).
  4. main path   the hot chain (two sources, fused filter + project,
                 two-key left-outer join, classifier, sentiment, dictionary
                 matcher, aggregate, sort, distinct branch) at 1,000,000
                 left-source rows on the numpy and torch planes: every sink
                 ``tables_identical``, the kernel launched, operators
                 lowered; then a four-key join that takes the device
                 sort/searchsorted probe.
  5. reuse       version 1 materialized on the torch plane, version 2 (an
                 edit below the join) served from the store: operators
                 reused, sinks and sink digests equal to a full numpy run.
  6. report      one JSON line of kernels, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP64_FLOP_PER_S = 34e12        # H100 SXM float64 outside the tensor cores
MAIN_ROWS = 1_000_000
KERNEL_SIZES = (0, 1, 7, 1023, 1025, 1_000_000, 16_000_000)
TIMED_SIZES = (1_000_000, 16_000_000)
SLEEP_CYCLES = 10_000_000  # ~5 ms of device sleep: longer than issuing any timed call


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. device -----------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


# -- 2. build ------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import relational as R

    info = R.build()
    log(f"build: relational.cu in {info['seconds']:.2f} s (cached={info['cached']})")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")
    R._library()  # load it and check the plan layout against the source
    return info


# -- 3. kernel against its plain version -----------------------------------------


def _adversarial(n: int, seed: int):
    """Columns a, b (float64) and c (int64) with every special value the
    reference's bands and numpy's NaN rules can tell apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.uniform(-1e6, 1e6, n)
    b = rng.uniform(-1e6, 1e6, n)
    c = rng.integers(-(2**53) - 8, 2**53 + 8, n, dtype=np.int64)
    if n:
        special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-12, -1e-12,
                            np.nextafter(1e-12, 1.0), np.nextafter(-1e-12, -1.0),
                            np.nextafter(1e-12, 0.0), 0.1, 0.2, 0.3, 1e15, -1e15])
        k = max(1, n // 8)
        a[rng.integers(0, n, k)] = rng.choice(special, k)
        b[rng.integers(0, n, k)] = rng.choice(special, k)
        c[rng.integers(0, n, k)] = rng.integers(-3, 4, k)
        # rows whose atoms land exactly on the bands
        m = rng.integers(0, n, k)
        b[m] = a[m]
        a[rng.integers(0, n, k)] = 1e-12
    return {"a": a, "b": b, "c": c}


def _cases():
    from fractions import Fraction

    from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred

    e1 = LinExpr.make({"a": Fraction(5, 2), "b": Fraction(-7, 4)}, Fraction(1, 3))
    e2 = LinExpr.make({"b": Fraction(1, 3), "c": 2}, Fraction(-1, 2))
    e3 = LinExpr.make({"a": 1, "b": -1}, 0)
    e4 = LinExpr.make({"a": 1}, Fraction(-1, 10**12))
    preds = [
        Pred.or_(
            Pred.and_(Pred.of(LinCmp(e1, "<=")), Pred.not_(Pred.of(LinCmp(e2, "<")))),
            Pred.of(NonLinearAtom("prod_pos", ("a", "b"))),
        ),
        Pred.and_(Pred.of(LinCmp(e3, "==")), Pred.of(LinCmp(e4, "!="))),
        Pred.or_(Pred.of(LinCmp(e3, "!=")), Pred.not_(Pred.of(LinCmp(e4, "==")))),
    ]
    proj = (("x", e1), ("y", e2), ("z", e3), ("k", LinExpr.make({}, 7)), ("a", "a"))
    return preds, proj


def _bits_equal(x, y, free=None):
    """Equal bit for bit, except that rows in ``free`` need only both be NaN."""
    import numpy as np

    if x.shape != y.shape:
        return False
    same = x.view(np.int64) == y.view(np.int64)
    if free is not None:
        same |= free & np.isnan(x) & np.isnan(y)
    return bool(same.all())


def _two_nan_rows(expr, t):
    """Rows where some add of ``eval_linexpr(expr, t)`` has two NaN operands
    with different bits.  IEEE 754 leaves the result's payload open there,
    and numpy's own choice varies with the array's length and the row's
    place in it (its vector loop returns one operand, its scalar tail the
    other), so no kernel can match numpy's bits in these rows: they must
    only be NaN in both."""
    import numpy as np

    acc = np.full(len(t), float(expr.const))
    free = np.zeros(len(t), dtype=bool)
    for c, v in expr.coeffs:
        prod = float(v) * t.cols[c].astype(np.float64)
        free |= np.isnan(acc) & np.isnan(prod) & (acc.view(np.int64) != prod.view(np.int64))
        acc = acc + prod
    return free


def _values_match_plain(kern, plain):
    """Equal bit for bit where neither is NaN, NaN in the same places."""
    import torch

    kn, pn = torch.isnan(kern), torch.isnan(plain)
    if not torch.equal(kn, pn):
        return False
    kb = kern.view(torch.int64)[~kn]
    pb = plain.view(torch.int64)[~pn]
    return torch.equal(kb, pb)


def _time_ms(fn, reps: int = 15) -> float:
    """Median device time of one call, with the L2 cache flushed before
    each (the main path reads columns it has just uploaded once).  The call
    is queued behind a device sleep, so the events bracket only device
    work, not the host time it takes to issue the call."""
    import torch

    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _call_ms(fn, reps: int = 15) -> float:
    """Median host wall time of one call up to its completion: device time
    plus the host time to issue it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel():
    import numpy as np
    import torch

    from repro_torch.core.predicates import Pred
    from repro_torch.engine.ops_impl import eval_linexpr, eval_pred
    from repro_torch.engine.plane import get_plane
    from repro_torch.engine.table import Table
    from repro_torch.kernels import relational as R

    np.seterr(all="ignore")  # inf - inf and NaN compares are the point here
    plane = get_plane("torch", device="cuda")
    preds, proj = _cases()
    max_err = 0.0
    timings = []
    nan_payload_same_as_plain = True
    two_nan_rows = 0
    for n in KERNEL_SIZES:
        cols = _adversarial(n, seed=n)
        t = Table(cols, ["a", "b", "c"])
        for pi, pred in enumerate(preds):
            plan = plane._compile_pred(pred)
            hosts = [torch.from_numpy(eval_pred(Pred.of(a), t)).to("cuda") for a in plan.host_atoms]
            dcols = [torch.from_numpy(t.cols[c]).to("cuda") for c in plan.columns]
            kern = R.relational(plan.program, dcols, hosts)
            plain = R.relational_reference(plan.program, dcols, hosts)
            want = eval_pred(pred, t)
            if not torch.equal(kern, plain):
                fail(f"filter {pi} n={n}: kernel mask differs from the plain version")
            if not np.array_equal(kern.cpu().numpy(), want):
                fail(f"filter {pi} n={n}: kernel mask differs from numpy eval_pred")
            if not np.array_equal(plane.pred_mask(pred, t), want):
                fail(f"filter {pi} n={n}: pred_mask differs from numpy eval_pred")
            if n in TIMED_SIZES and pi == 0:
                nbytes = n * (8 * len(dcols) + len(hosts) + 1)
                flops = n * 2 * len(plan.program.prods)
                timings.append(("filter", n, _time_ms(lambda: R.relational(plan.program, dcols, hosts)),
                                _time_ms(lambda: R.relational_reference(plan.program, dcols, hosts)),
                                *_bound_ms(nbytes, flops)))
        pplan = plane._compile_proj(proj)
        dcols = [torch.from_numpy(t.cols[c]).to("cuda") for c in pplan.columns]
        kern = R.relational(pplan.program, dcols)
        plain = R.relational_reference(pplan.program, dcols)
        for (name, kind, ti) in pplan.items:
            if kind != "lin":
                continue
            expr = dict(proj)[name]
            want = eval_linexpr(expr, t)
            got = kern[ti].cpu().numpy()
            free = _two_nan_rows(expr, t)
            two_nan_rows += int(free.sum())
            if not _bits_equal(got, want, free):
                fail(f"project {name} n={n}: kernel bits differ from numpy eval_linexpr")
            if not _values_match_plain(kern[ti], plain[ti]):
                fail(f"project {name} n={n}: kernel differs from the plain version")
            nan_payload_same_as_plain &= bool(torch.equal(kern[ti].view(torch.int64),
                                                          plain[ti].view(torch.int64)))
            ok = ~torch.isnan(kern[ti])
            if n:
                diff = (kern[ti][ok] - plain[ti][ok]).abs()
                diff = diff[torch.isfinite(diff)]
                if diff.numel():
                    max_err = max(max_err, float(diff.max()))
        if n in TIMED_SIZES:
            nbytes = n * (8 * len(dcols) + 8 * len(pplan.program.terms))
            flops = n * 2 * len(pplan.program.prods)
            timings.append(("project", n, _time_ms(lambda: R.relational(pplan.program, dcols)),
                            _time_ms(lambda: R.relational_reference(pplan.program, dcols)),
                            *_bound_ms(nbytes, flops)))
        log(f"kernel: n={n} filters x{len(preds)} + project bit-identical")
    large_err, large_two_nan = _check_large_programs(plane)
    max_err = max(max_err, large_err)
    log(f"kernel: rows where numpy's NaN bits are left open (two NaN addends): "
        f"{two_nan_rows} adversarial, {large_two_nan} large; NaN in both there")
    log(f"kernel: NaN payloads equal to the plain version's too: {nan_payload_same_as_plain}")
    for kind, n, ms, plain_ms, bound, by in timings:
        log(f"kernel time: {kind} n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")
    return max_err, timings


WIDE_SIZES = (1025, 200_000)


def _large_programs(names):
    """Programs beyond any small fixed plan: a filter over 17 columns with
    40 atoms and 10 host masks, an and/or chain nested 100 deep, a filter
    of 240 atoms whose plan outgrows the kernel's 48 KiB of shared memory,
    and a projection of 40 values."""
    import numpy as np
    from fractions import Fraction

    from repro_torch.core.predicates import LinCmp, LinExpr, Pred, StrEq

    rng = np.random.default_rng(31)

    def expr(cols=names):
        return LinExpr.make({c: Fraction(int(rng.integers(-9, 10)) or 1, int(rng.integers(1, 5)))
                             for c in cols}, Fraction(int(rng.integers(-3, 4)), 2))

    def atoms(k):
        return [Pred.of(LinCmp(expr(), ("<=", "<", "!=", "==")[i % 4])) for i in range(k)]

    wide = atoms(40)
    hosts = [Pred.of(StrEq("t", "uvw"[i % 3])) for i in range(10)]
    deep = Pred.cmp(names[0], "<=", 0)
    for i in range(100):
        atom = Pred.of(LinCmp(expr(names[i % 3:i % 3 + 2]), "<="))
        deep = Pred.and_(atom, deep) if i % 2 else Pred.or_(atom, deep)
    huge = atoms(240)
    preds = {
        "wide": Pred.or_(*[Pred.and_(*wide[i:i + 4], hosts[i // 4]) for i in range(0, 40, 4)]),
        "deep": deep,
        "huge": Pred.or_(*[Pred.and_(*huge[i:i + 3]) for i in range(0, 240, 3)]),
    }
    proj = tuple((f"v{i}", expr()) for i in range(40))
    return preds, proj


def _check_large_programs(plane) -> float:
    """The large programs through the kernel, its plain version and numpy:
    masks equal, values equal bit for bit (see ``_two_nan_rows``).  Returns
    the largest absolute difference from the plain version over non-NaN
    values, and the number of rows whose NaN bits numpy leaves open."""
    import numpy as np
    import torch

    from repro_torch.core.predicates import Pred
    from repro_torch.engine.ops_impl import eval_linexpr, eval_pred
    from repro_torch.engine.table import Table
    from repro_torch.kernels import relational as R

    names = [f"a{i}" for i in range(17)]
    preds, proj = _large_programs(names)
    max_err = 0.0
    two_nan_rows = 0
    for n in WIDE_SIZES:
        rng = np.random.default_rng(n + 7)
        cols = {c: rng.uniform(-4, 4, n) for c in names}
        cols["a16"] = rng.integers(-4, 5, n, dtype=np.int64)
        for c in names[:4]:
            cols[c][rng.integers(0, n, n // 16)] = rng.choice(
                np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-12]), n // 16)
        cols["t"] = rng.choice(np.array(["u", "v", "w"], dtype=object), n)
        t = Table(cols, names + ["t"])
        for name, pred in preds.items():
            plan = plane._compile_pred(pred)
            hosts = [torch.from_numpy(eval_pred(Pred.of(a), t)).to("cuda") for a in plan.host_atoms]
            dcols = [torch.from_numpy(t.cols[c]).to("cuda") for c in plan.columns]
            kern = R.relational(plan.program, dcols, hosts)
            if not torch.equal(kern, R.relational_reference(plan.program, dcols, hosts)):
                fail(f"large filter {name} n={n}: kernel mask differs from the plain version")
            if not np.array_equal(kern.cpu().numpy(), eval_pred(pred, t)):
                fail(f"large filter {name} n={n}: kernel mask differs from numpy eval_pred")
            if n == WIDE_SIZES[0]:
                words = len(R._pack(plan.program, dcols, hosts, [kern]))
                log(f"kernel: large filter {name}: {plan.program.n_cols} columns, "
                    f"{len(plan.program.terms)} atoms, {len(plan.program.prods)} products, "
                    f"{plan.program.n_hosts} host masks, stack depth {plan.program.depth()}, "
                    f"plan {8 * words} bytes ({'shared' if 8 * words <= 48 * 1024 else 'device'} "
                    f"memory)")
        pplan = plane._compile_proj(proj)
        dcols = [torch.from_numpy(t.cols[c]).to("cuda") for c in pplan.columns]
        kern = R.relational(pplan.program, dcols)
        plain = R.relational_reference(pplan.program, dcols)
        for name, kind, ti in pplan.items:
            free = _two_nan_rows(dict(proj)[name], t)
            two_nan_rows += int(free.sum())
            if not _bits_equal(kern[ti].cpu().numpy(), eval_linexpr(dict(proj)[name], t), free):
                fail(f"large project {name} n={n}: kernel bits differ from numpy eval_linexpr")
            if not _values_match_plain(kern[ti], plain[ti]):
                fail(f"large project {name} n={n}: kernel differs from the plain version")
            ok = ~torch.isnan(kern[ti])
            diff = (kern[ti][ok] - plain[ti][ok]).abs()
            diff = diff[torch.isfinite(diff)]
            if diff.numel():
                max_err = max(max_err, float(diff.max()))
        log(f"kernel: n={n} large filters x{len(preds)} + {len(proj)}-value project bit-identical")
    return max_err, two_nan_rows


# -- 4. the main path ----------------------------------------------------------


def hot_chain():
    """Two sources, a branch, and every hot operator family once: a fused
    filter+project front, a two-key left-outer join, two deterministic
    "models", a dictionary matcher, a two-column hash aggregate, a sort, and
    a distinct branch off the projection (the data-plane benchmark's chain)."""
    from repro_torch.core import dag as D
    from repro_torch.core.predicates import LinCmp, LinExpr, Pred

    ops = [
        D.Operator.make("s1", D.SOURCE, schema=("k", "k2", "g", "x")),
        D.Operator.make("s2", D.SOURCE, schema=("k", "k2", "y")),
        D.Operator.make(
            "f1", D.FILTER,
            pred=Pred.and_(
                Pred.cmp("x", "<=", 5),
                Pred.of(LinCmp(LinExpr.make({"g": -1, "x": 2}, 1), "<=")),
            ),
        ),
        D.Operator.make(
            "p1", D.PROJECT,
            cols=(
                ("k", "k"),
                ("k2", "k2"),
                ("g", "g"),
                ("x2", LinExpr.make({"x": 2, "g": 1}, -0.5)),
            ),
        ),
        D.Operator.make(
            "j", D.JOIN, on=(("k", "k"), ("k2", "k2")), how="left_outer"
        ),
        D.Operator.make("cl", D.CLASSIFIER, col="g", classes=5, out="cls"),
        D.Operator.make("se", D.SENTIMENT, col="x2", out="sent"),
        D.Operator.make(
            "dm", D.DICT_MATCHER, col="g",
            entries=(1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0), out="hit",
        ),
        D.Operator.make(
            "ag", D.AGGREGATE,
            group_by=("g", "cls"),
            aggs=(("sum", "x2", "sx"), ("count", "*", "cnt"), ("avg", "y", "ay")),
        ),
        D.Operator.make(
            "so", D.SORT, keys=(("sx", True), ("g", True), ("cls", True))
        ),
        D.Operator.make("k1", D.SINK, semantics=D.ORDERED),
        D.Operator.make("di", D.DISTINCT),
        D.Operator.make("k2", D.SINK, semantics=D.BAG),
    ]
    links = [
        D.Link("s1", "f1"),
        D.Link("f1", "p1"),
        D.Link("p1", "j", 0),
        D.Link("s2", "j", 1),
        D.Link("j", "cl"),
        D.Link("cl", "se"),
        D.Link("se", "dm"),
        D.Link("dm", "ag"),
        D.Link("ag", "so"),
        D.Link("so", "k1"),
        D.Link("p1", "di"),
        D.Link("di", "k2"),
    ]
    return D.DataflowDAG(ops=ops, links=links)


def hot_sources(rows: int, seed: int = 0):
    """High-cardinality primary keys + a low-cardinality secondary key (most
    left rows unmatched: the outer pad is exercised), mid-cardinality
    groups, small-domain filter values."""
    import numpy as np

    from repro_torch.engine.table import Table

    rng = np.random.default_rng(seed)
    n2 = max(rows // 4, 1)
    return {
        "s1": Table(
            {
                "k": rng.integers(0, rows, rows).astype(np.float64),
                "k2": rng.integers(0, 4, rows).astype(np.float64),
                "g": rng.integers(0, 1024, rows).astype(np.float64),
                "x": rng.integers(0, 7, rows).astype(np.float64),
            },
            ["k", "k2", "g", "x"],
        ),
        "s2": Table(
            {
                "k": rng.integers(0, rows, n2).astype(np.float64),
                "k2": rng.integers(0, 4, n2).astype(np.float64),
                "y": rng.integers(0, 7, n2).astype(np.float64),
            },
            ["k", "k2", "y"],
        ),
    }


def _all_identical(ref, got, what):
    from repro_torch.engine.table import tables_identical

    if set(ref) != set(got):
        fail(f"{what}: sink sets differ: {sorted(ref)} vs {sorted(got)}")
    for s in ref:
        if not tables_identical(ref[s], got[s]):
            fail(f"{what}: sink {s} differs between the numpy and torch planes")


def _device_busy(run):
    """Device time of one run from torch.profiler, by kind: host<->device
    copies, the relational kernel, everything else on the device; with the
    run's wall time inside the profiled window.  None where the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {"copy_s": 0.0, "relational_kernel_s": 0.0, "other_s": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.key.lower()
        kind = ("copy_s" if "memcpy" in name else
                "relational_kernel_s" if "relational_kernel" in name else "other_s")
        busy[kind] += ev.device_time_total / 1e6
    if not any(busy.values()):
        return None
    busy["wall_s"] = wall
    busy["idle_share"] = 1.0 - sum(v for k, v in busy.items() if k.endswith("_s") and k != "wall_s") / wall
    return busy


def _host_breakdown(plane, run):
    """Host wall time of one run, per operator, and the time spent in the
    plane's host<->device copies (each copy timed between synchronizations,
    so it includes the staging of pageable memory)."""
    import torch

    times, copy = {}, [0.0]
    to_device, to_host, execute_op = plane._to_device, plane._to_host, plane.execute_op

    def timed_copy(fn):
        def wrapper(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            copy[0] += time.perf_counter() - t0
            return out
        return wrapper

    def timed_op(op, inputs):
        t0 = time.perf_counter()
        out = execute_op(op, inputs)
        times[op.id] = times.get(op.id, 0.0) + time.perf_counter() - t0
        return out

    plane._to_device, plane._to_host = timed_copy(to_device), timed_copy(to_host)
    plane.execute_op = timed_op
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:  # drop the instance attributes: the class methods show again
        del plane._to_device, plane._to_host, plane.execute_op
    return wall, copy[0], times


def phase_main_path():
    import numpy as np

    from repro_torch.core import dag as D
    from repro_torch.engine import ExecutionPlan, execute, get_plane
    from repro_torch.engine.table import Table
    from repro_torch.kernels import relational as R

    dag = hot_chain()
    sources = hot_sources(MAIN_ROWS)
    # warm-up at full size on other data: first-use costs (the exactness
    # probe, CUDA context, allocator growth) stay out of the timed run
    execute(dag, hot_sources(MAIN_ROWS, seed=1))  # the torch plane on cuda by default

    t0 = time.perf_counter()
    ref = execute(dag, sources, plane="numpy")
    t_numpy = time.perf_counter() - t0

    R.relational.launches = 0
    t0 = time.perf_counter()
    res = ExecutionPlan(dag, sources).run()
    t_torch = time.perf_counter() - t0
    launches = R.relational.launches

    _all_identical(ref, res.results, "hot chain")
    if launches <= 0:
        fail("hot chain: the relational kernel was never launched on the torch plane")
    if res.stats.ops_lowered <= 0:
        fail("hot chain: no operator was lowered on the torch plane")
    log(f"main path: hot chain {MAIN_ROWS} rows: numpy {t_numpy:.3f} s, torch {t_torch:.3f} s, "
        f"{res.stats.ops_lowered} ops lowered, {launches} relational launches, sinks identical")

    plane = get_plane("torch", device="cuda")
    run = lambda: execute(dag, sources)  # noqa: E731
    wall, copy_s, per_op = _host_breakdown(plane, run)
    ops = ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_op.items(), key=lambda kv: -kv[1]))
    log(f"main path: instrumented torch run {wall:.3f} s; host<->device copies {copy_s:.4f} s "
        f"({100 * copy_s / wall:.2f}%); per operator (s): {ops}")
    busy = _device_busy(run)
    if busy is None:
        log("main path: device busy time not measured (the profiler saw no device activity)")
    else:
        log(f"main path: profiled torch run {busy['wall_s']:.3f} s; device time: copies "
            f"{busy['copy_s']:.4f} s, relational kernel {busy['relational_kernel_s']:.6f} s, "
            f"other {busy['other_s']:.4f} s; device idle share {busy['idle_share']:.4f}")

    # the kernel's timing at the main path's own shape: f1 over s1's columns
    import torch

    f1 = plane._pred_plan(dag.ops["f1"].get("pred"))
    s1 = sources["s1"]
    dcols = [torch.from_numpy(s1.cols[c]).to("cuda") for c in f1.columns]
    ms = _time_ms(lambda: R.relational(f1.program, dcols))
    plain_ms = _time_ms(lambda: R.relational_reference(f1.program, dcols))
    call_ms = _call_ms(lambda: R.relational(f1.program, dcols))
    bound, by = _bound_ms(len(s1) * (8 * len(dcols) + 1), len(s1) * 2 * len(f1.program.prods))
    main_shape = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    log(f"main path: relational kernel at f1's shape ({len(s1)} rows, {len(dcols)} columns): "
        f"{ms:.4f} ms on the device (a whole wrapper call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")

    # a four-key join: the combined code range is sparse, so the plane
    # takes the device sort/searchsorted probe
    rng = np.random.default_rng(9)
    n = MAIN_ROWS
    lcols = {f"k{i}": rng.permutation(n).astype(np.float64) for i in range(4)}
    lcols["x"] = np.arange(float(n))
    ridx = rng.permutation(n)[: n // 2]
    rcols = {f"k{i}": lcols[f"k{i}"][ridx] for i in range(4)}
    rcols["y"] = np.arange(float(n // 2))
    jdag = D.DataflowDAG(
        [D.Operator.make("l", D.SOURCE, schema=tuple(lcols)),
         D.Operator.make("r", D.SOURCE, schema=tuple(rcols)),
         D.Operator.make("j", D.JOIN, on=tuple((f"k{i}", f"k{i}") for i in range(4)),
                         how="left_outer"),
         D.Operator.make("sink", D.SINK, semantics=D.ORDERED)],
        [D.Link("l", "j", 0), D.Link("r", "j", 1), D.Link("j", "sink")],
    )
    jsrc = {"l": Table(lcols, list(lcols)), "r": Table(rcols, list(rcols))}
    probes = plane.device_probes
    t0 = time.perf_counter()
    got = execute(jdag, jsrc)
    t_j = time.perf_counter() - t0
    if plane.device_probes != probes + 1:
        fail("sparse join: the device probe was not taken")
    _all_identical(execute(jdag, jsrc, plane="numpy"), got, "sparse join")
    log(f"main path: four-key left-outer join {n} x {n // 2} rows through the device probe "
        f"in {t_j:.3f} s, sink identical")
    return {"launches": launches, "t_numpy": t_numpy, "t_torch": t_torch,
            "main_shape": main_shape}


# -- 5. execute with reuse -----------------------------------------------------


def phase_reuse():
    from repro_torch.engine import ExecutionPlan, InMemoryMaterializationStore, table_digest
    from repro_torch.kernels import relational as R

    v1 = hot_chain()
    v2 = v1.replace_op(v1.ops["dm"].with_props(entries=(1.0, 2.0, 4.0, 8.0, 16.0)))
    sources = hot_sources(MAIN_ROWS, seed=2)
    store = InMemoryMaterializationStore()

    R.relational.launches = 0
    ExecutionPlan(v1, sources).run(store=store, materialize=True)
    plan2 = ExecutionPlan(v2, sources)
    res2 = plan2.run(store=store, serve_from_store=True, materialize=True)
    launches = R.relational.launches
    ref_plan = ExecutionPlan(v2, sources, plane="numpy")
    ref2 = ref_plan.run()
    if res2.stats.ops_reused <= 0:
        fail("reuse: version 2 reused no operator")
    if launches <= 0:
        fail("reuse: the relational kernel was never launched")
    _all_identical(ref2.results, res2.results, "reuse")
    if plan2.digests != ref_plan.digests:
        fail("reuse: operator content digests differ between the planes")
    for s in ref2.results:
        if table_digest(ref2.results[s]) != table_digest(res2.results[s]):
            fail(f"reuse: sink {s} table digest differs between the planes")
    log(f"reuse: version 2 reused {res2.stats.ops_reused} ops, executed "
        f"{res2.stats.ops_executed}, {launches} relational launches over both versions; "
        f"sinks and digests equal to a full numpy run")
    return launches


def main() -> int:
    card = phase_device()
    import torch

    build = phase_build()
    max_err, _ = phase_kernel()
    main = phase_main_path()
    phase_reuse()
    shape = main["main_shape"]
    kernels = [{
        "name": "relational",
        "route": "cuda",
        "source": "src/repro_torch/csrc/relational.cu",
        "replaces": "src/repro/kernels/relational.py:111",
        "launches": main["launches"],
        "max_abs_err": max_err,
        "ms": shape["ms"],
        "plain_ms": shape["plain_ms"],
        "bound_ms": shape["bound_ms"],
        "bound_by": shape["bound_by"],
        "library_ms": None,
    }]
    log(f"build seconds: {build['seconds']:.2f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
