#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU, end to end.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

  1. device      CUDA must be available; prints the card's name and power
                 limit as ``nvidia-smi`` gives them.
  2. build       compiles the six kernel sources of ``src/repro_torch/csrc/``
                 (relational, rmsnorm, flash_attention and ssd_scan for fp32,
                 flash_attention_sm90 and ssd_scan_sm90 for bf16 on the
                 tensor cores), one nvcc each, all started together.
  3. kernel      the relational kernel against its plain PyTorch version on
                 the card and against the numpy reference, on adversarial
                 inputs (uniform +-1e6, int64, NaN, +-0, +-inf, values on the
                 +-1e-12 bands) at n in {0, 1, 7, 1023, 1025, 1M, 16M}, and
                 at 1025 and 1M over column views at an odd element offset;
                 then programs of 17 columns, 240 atoms, 10 host masks,
                 a tree nested 100 deep and 40 projected values.  Each
                 program's route (plan in the launch's 1 KiB of
                 parameters, or in device memory) is reported, and every
                 route's instance must be launched.
                 Tolerance: none.  Masks must be equal; values must be equal
                 bit for bit to numpy (NaN bits too, except where an add
                 has two different NaN operands, whose result numpy itself
                 leaves open: NaN in both there), and to the plain version
                 except for NaN payloads (its NaNs are the card's own).
                 Timed at 1M and 16M rows: the call's device time (events),
                 the kernel's own (profiler), a whole call's wall time.
  4. main path   the hot chain (two sources, fused filter + project,
                 two-key left-outer join, classifier, sentiment, dictionary
                 matcher, aggregate, sort, distinct branch) at 1,000,000
                 left-source rows on the numpy and torch planes: every sink
                 ``tables_identical``, the kernel launched, every launch
                 through a parameter plan, operators lowered; the kernel
                 timed at f1's and p1's own shapes; then a four-key join
                 that takes the device sort/searchsorted probe.
  5. reuse       version 1 materialized on the torch plane, version 2 (an
                 edit below the join) served from the store: operators
                 reused, sinks and sink digests equal to a full numpy run.
  6. verify      four successor versions of the hot chain (f1 split in two,
                 an implied filter spliced in, f1's constant tightened, the
                 dictionary matcher edited) verified against it with the
                 Equitas, Spes and UDP EVs: each verdict equal to the
                 reference package's (``VERIFY_EXPECTED``), each decided
                 verdict's certificate replayed against the pair, round-
                 tripped through JSON, and a tampered copy refused; then
                 both versions executed at 1,000,000 rows on the torch plane
                 (``sink_results_equal``): equal sinks for every EQ verdict,
                 and each pair's equality as pinned (``SINKS_EQUAL``); the
                 relational kernel must launch.  Tolerance: none.
  7. chain      version chains through ``VersionChainSession`` on the torch
                 plane, every version at 1,000,000 rows per source: (a) the
                 synthetic chain ``make_chain(6, heavy=True)`` (5 branches
                 of filter, filter, project, classifier, aggregate; 5
                 sources) in exec_mode full and reuse; (b) the
                 dominated-filter chain of ``tests/test_delta_exec.py``
                 (thresholds 80, 74, 77, 71, 90, 62: narrow and widen
                 edits) in exec_mode delta and full; (c) ``ReuseManager``
                 on a disk store under ``build/`` with two versions of (a).
                 Every sink ``tables_identical`` to a numpy-plane run of its
                 version (the reuse manager's to a full torch-plane run);
                 every successor EQ, certified, its certificate replayed
                 against the pair; operators reused in reuse mode and none
                 in full mode; every delta successor through the delta
                 tier (ops_delta and delta rows > 0) with the relational
                 kernel launched inside the delta runs (the delta masks).
                 Apart from the runs, the boundary mask over 1M rows: the
                 plane's ``pred_mask`` against ``eval_pred``, the kernel
                 against its plain version, both timed.  Tolerance: none.
  6b. verify-corpus a seeded corpus of the port's ``SessionGenerator``
                 (``smoke_config(0)`` cut to 4 of its 8 sessions: 100 pairs
                 over the W1-W8 shapes) verified under the full roster
                 (Equitas, Spes, UDP and the traced EV), unguided and with
                 ``guidance="model"``: every decided verdict's certificate
                 replayed, no equivalent-by-construction pair NEQ, guided
                 and unguided never disagreeing where both decide, and the
                 traced EV asked.  Logs the verification time per pair,
                 each EV's checks and seconds, and the decompositions
                 explored to the first certificate, guided and unguided.
  7b. service   phase 7's chains through (a) a ``VerificationService`` of
                 3 threads and (b) a ``VerificationFleet`` of 2 worker
                 processes on the file tier (under ``build/``), both on
                 ``device="cuda"`` with ``exec_mode="delta"``, the fleet
                 started after every earlier phase used the card in this
                 process: two clients run the synthetic chain (its edits
                 are not delta-amenable: the reuse path), one the
                 dominated-filter chain (the delta tier), 1,000,000 rows a
                 source.  Every sink ``tables_identical`` to phase 7's
                 in-process run of the version, every successor EQ with a
                 certificate that replays, relational launches in the
                 service, and in each fleet worker that executed (its
                 drain stats' ``relational_launches``).  Logs per-client
                 submit-to-result times, the service's and the fleet's wall
                 times, the bytes and seconds of pickling each submit's
                 message (measured apart from the fleet) and the file
                 tier's payload writes (the workers' own clocks).
  8. llm-kernels flash attention, RMSNorm and the SSD scan against their
                 plain PyTorch versions on the card: flash attention at the
                 prefill shape (B=2, S=T=4096, H=32, KV=8, D=128, bf16,
                 causal), at window=1024, chunk=1024, q_offset>0 with S<T,
                 causal=False, a tail S=4095, and fp32 at a small shape;
                 RMSNorm at (8192, 4096) bf16, decode rows (4, 1, 4096),
                 fp32, D=5376, D=12288, D=4097 and mamba2's D=2560 and 5120;
                 the SSD scan at mamba2's prefill shape (B=2, L=4096, H=80,
                 P=64, G=1, N=128, chunk 256, bf16), a single chunk, G=2, a
                 nonzero initial state, B=1, and fp32 at the three shapes of
                 ``tests/test_kernels.py``, and bf16 at chunks of 128 and 64.
                 Tolerances: attention fp32 2e-6,
                 bf16 2e-2 (atol = rtol); RMSNorm fp32 1e-6, bf16 one bf16
                 unit in the last place; SSD fp32 1e-5, bf16 y 2e-2, final
                 state 1e-5 (1e-4 at chunks of 256, ``_ssd_tols``).  Every
                 call must launch the instance of its dtype (bf16: tensor
                 cores; fp32: CUDA cores), and every bf16 result must also
                 agree with the plain mirror of the tensor-core arithmetic
                 (``MIRROR_ATOL``).  Each kernel is timed at the prefill
                 shape beside its plain version, one PyTorch library call
                 where there is one, and its bound.
  9. serve       llama3-8b at full width and depth (32 layers, d 4096), fp32
                 weights drawn from --seed on the card: ``forward_step`` on
                 2 prompts of 4096 tokens through the kernels (32 flash
                 attention launches, all of the tensor-core instance, and 65
                 RMSNorm launches), ``greedy_generate`` on
                 4 prompts of 128 tokens with 32 new tokens (prefill wall
                 time, decode tokens per second, memory high-water mark);
                 then the same forward on the plain path (no launch), with
                 every flash attention and RMSNorm input of it also given
                 to the kernel (each within its tolerance), the logits
                 against the kernel path's beside a control (the plain path
                 summed in another order), and 64 decode steps against the
                 forward's logits on both paths (see LOGIT_TOL).
  10. serve-mamba mamba2-2.7b at full width and depth (64 layers, d 2560, 80
                 heads of 64, state 128, vocab 50280), fp32 weights from
                 --seed, after llama3-8b's tensors are freed: the same
                 steps as phase 9 (64 SSD launches, all of the tensor-core
                 instance, and 129 RMSNorm launches per
                 ``forward_step``), the SSD kernel also held to its plain
                 version on every layer's inputs, and the control the plain
                 path with SSD chunks of 128 instead of 256 (the same
                 function summed in another order).
  11. report     one JSON line of kernels (launches summed over both
                 serving paths, the relational kernel's over phases 4, 7
                 and 7b's service; relational, flash attention and the SSD scan also by
                 instance), the card's name and power limit, then the
                 result line.

Options: ``--seed N`` (default 0) seeds the serving phase's weights and
tokens.
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
BF16_TENSOR_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
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


def _kernel_modules():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import relational as R
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import ssd_scan as SS

    return R, RMS, FA, SS


def _reset_counts():
    R, RMS, FA, SS = _kernel_modules()
    R.relational.launches = RMS.rmsnorm.launches = 0
    for route in R.relational.launches_by_instance:
        R.relational.launches_by_instance[route] = 0
    for w in (FA.flash_attention, SS.ssd_scan):
        w.launches = w.launches_tc = w.launches_fp32 = 0


def _counts():
    R, RMS, FA, SS = _kernel_modules()
    return {"relational": R.relational.launches, "rmsnorm": RMS.rmsnorm.launches,
            "flash_attention": FA.flash_attention.launches, "ssd_scan": SS.ssd_scan.launches}


def _instance_counts():
    """Launches of each instance of the kernels that have two: ``tc`` (bf16,
    tensor cores) and ``fp32`` (CUDA cores)."""
    _, _, FA, SS = _kernel_modules()
    return {name: {"tc": w.launches_tc, "fp32": w.launches_fp32}
            for name, w in (("flash_attention", FA.flash_attention), ("ssd_scan", SS.ssd_scan))}


def _relational_instances():
    """Launches of each relational instance, by the route of its plan."""
    R = _kernel_modules()[0]
    return dict(R.relational.launches_by_instance)


def phase_build():
    from repro_torch.kernels import _build

    R, RMS, FA, SS = _kernel_modules()
    t0 = time.perf_counter()
    infos = _build.build(R.SOURCE, RMS.SOURCE, FA.SOURCE, FA.SOURCE_TC, SS.SOURCE, SS.SOURCE_TC)
    wall = time.perf_counter() - t0
    for name, info in infos.items():
        log(f"build: {name}.cu in {info['seconds']:.2f} s (cached={info['cached']})")
        for line in str(info["log"]).splitlines():
            if any(w in line for w in ("registers", "spill", "error", "C75")):
                log(f"  ptxas: {line.strip()}")
    # load each and check the relational plan layout against the source
    R._library(), RMS._library(), FA._library(), FA._library_tc(), SS._library(), SS._library_tc()
    log(f"build: all kernels in {wall:.2f} s of wall time")
    return {"seconds": wall}


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


def _kernel_only_ms(fn, name: str = "relational_kernel", reps: int = 15):
    """Mean device time of the launches of kernel ``name`` in one call, with
    the L2 cache flushed before each call, from torch.profiler's entries
    whose name holds ``name``: the call's other device work (a plan upload)
    is left out.  None where the profiler saw no such launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us = count = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and name in ev.key:
            total_us += ev.device_time_total
            count += ev.count
    return total_us / 1e3 / count if count else None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _timed(kind, n, fn, plain, nbytes, flops, route):
    """One timing record of a relational call: the call's device time
    (events), the kernel's own (profiler), the host wall time of a whole
    call, the plain version's device time and the bound."""
    bound, by = _bound_ms(nbytes, flops)
    return {"kind": kind, "n": n, "route": route, "ms": _time_ms(fn), "kernel_ms": _kernel_only_ms(fn),
            "call_ms": _call_ms(fn), "plain_ms": _time_ms(plain), "bound_ms": bound, "bound_by": by}


def _log_timed(prefix, t):
    share = "" if not t["ms"] else f", {100 * t['bound_ms'] / t['ms']:.1f}% of the bound"
    log(f"{prefix}{t['kind']} n={t['n']} ({t['route']}): call {t['ms']:.4f} ms on the device "
        f"(events), kernel alone {_fmt_ms(t['kernel_ms'])} (profiler), whole call "
        f"{t['call_ms']:.4f} ms wall, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}){share}")


def _bound_ms(nbytes: float, flops: float, flop_rate: float = FP64_FLOP_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _on_card(x, offset: int = 0):
    """The numpy array ``x`` on the card, as a view ``offset`` elements into
    a larger buffer (1: a float64 column's address 8 bytes off every 16-byte
    boundary, read with 8-byte copies)."""
    import numpy as np
    import torch

    buf = torch.from_numpy(np.concatenate([np.zeros(offset, dtype=x.dtype), x])).to("cuda")
    view = buf[offset:]
    if len(x) and view.data_ptr() % 16 != offset * x.itemsize % 16:
        fail(f"a view at offset {offset} is not where it should be in its buffer")
    return view


ODD_OFFSET_SIZES = (1025, 1_000_000)


def phase_kernel():
    from repro_torch.engine.plane import get_plane
    from repro_torch.kernels import relational as R

    plane = get_plane("torch", device="cuda")
    _reset_counts()
    preds, proj = _cases()
    max_err = 0.0
    timings = []
    nan_payload_same_as_plain = True
    two_nan_rows = 0
    cases = [(n, 0) for n in KERNEL_SIZES] + [(n, 1) for n in ODD_OFFSET_SIZES]
    for n, offset in cases:
        err, rows, same, timed = _check_adversarial(plane, preds, proj, n, offset)
        max_err = max(max_err, err)
        two_nan_rows += rows
        nan_payload_same_as_plain &= same
        timings += timed
    log("kernel: routes of the adversarial programs: "
        + ", ".join(f"filter {i} {R.route(plane._compile_pred(p).program)} "
                    f"({8 * R.plan_words(plane._compile_pred(p).program)} bytes)"
                    for i, p in enumerate(preds))
        + f", project {R.route(plane._compile_proj(proj).program)}")
    large_err, large_two_nan = _check_large_programs(plane)
    max_err = max(max_err, large_err)
    by_instance = _relational_instances()
    log(f"kernel: relational launches by instance in this phase: {by_instance}")
    for route, count in by_instance.items():
        if count <= 0:
            fail(f"kernel: the relational instance {route} was never launched")
    log(f"kernel: rows where numpy's NaN bits are left open (two NaN addends): "
        f"{two_nan_rows} adversarial, {large_two_nan} large; NaN in both there")
    log(f"kernel: NaN payloads equal to the plain version's too: {nan_payload_same_as_plain}")
    for t in timings:
        _log_timed("kernel time: ", t)
    return max_err, timings


def _check_adversarial(plane, preds, proj, n: int, offset: int):
    """The adversarial programs over n rows of columns and host masks placed
    ``offset`` elements into their buffers: masks equal to the plain version
    and numpy, values equal bit for bit (see ``_two_nan_rows``); timed at
    offset 0 and n in TIMED_SIZES.  Returns the largest absolute difference
    from the plain version over non-NaN values, the rows whose NaN bits
    numpy leaves open, whether every NaN payload equals the plain
    version's, and the timing records."""
    import numpy as np
    import torch

    from repro_torch.core.predicates import Pred
    from repro_torch.engine.ops_impl import eval_linexpr, eval_pred
    from repro_torch.engine.table import Table
    from repro_torch.kernels import relational as R

    np.seterr(all="ignore")  # inf - inf and NaN compares are the point here
    what = f"n={n}" + (f" at offset {offset}" if offset else "")
    timed = offset == 0 and n in TIMED_SIZES
    t = Table(_adversarial(n, seed=n + offset), ["a", "b", "c"])
    max_err = 0.0
    two_nan_rows = 0
    nan_same = True
    timings = []
    for pi, pred in enumerate(preds):
        plan = plane._compile_pred(pred)
        hosts = [_on_card(eval_pred(Pred.of(a), t), offset) for a in plan.host_atoms]
        dcols = [_on_card(t.cols[c], offset) for c in plan.columns]
        kern = R.relational(plan.program, dcols, hosts)
        plain = R.relational_reference(plan.program, dcols, hosts)
        want = eval_pred(pred, t)
        if not torch.equal(kern, plain):
            fail(f"filter {pi} {what}: kernel mask differs from the plain version")
        if not np.array_equal(kern.cpu().numpy(), want):
            fail(f"filter {pi} {what}: kernel mask differs from numpy eval_pred")
        if offset == 0 and not np.array_equal(plane.pred_mask(pred, t), want):
            fail(f"filter {pi} {what}: pred_mask differs from numpy eval_pred")
        if timed and pi == 0:
            timings.append(_timed(
                "filter", n, lambda: R.relational(plan.program, dcols, hosts),
                lambda: R.relational_reference(plan.program, dcols, hosts),
                n * (8 * len(dcols) + len(hosts) + 1), n * 2 * len(plan.program.prods),
                R.route(plan.program)))
    pplan = plane._compile_proj(proj)
    dcols = [_on_card(t.cols[c], offset) for c in pplan.columns]
    kern = R.relational(pplan.program, dcols)
    plain = R.relational_reference(pplan.program, dcols)
    for (name, kind, ti) in pplan.items:
        if kind != "lin":
            continue
        expr = dict(proj)[name]
        free = _two_nan_rows(expr, t)
        two_nan_rows += int(free.sum())
        if not _bits_equal(kern[ti].cpu().numpy(), eval_linexpr(expr, t), free):
            fail(f"project {name} {what}: kernel bits differ from numpy eval_linexpr")
        if not _values_match_plain(kern[ti], plain[ti]):
            fail(f"project {name} {what}: kernel differs from the plain version")
        nan_same &= bool(torch.equal(kern[ti].view(torch.int64), plain[ti].view(torch.int64)))
        ok = ~torch.isnan(kern[ti])
        if n:
            diff = (kern[ti][ok] - plain[ti][ok]).abs()
            diff = diff[torch.isfinite(diff)]
            if diff.numel():
                max_err = max(max_err, float(diff.max()))
    if timed:
        timings.append(_timed(
            "project", n, lambda: R.relational(pplan.program, dcols),
            lambda: R.relational_reference(pplan.program, dcols),
            n * (8 * len(dcols) + 8 * len(pplan.program.terms)),
            n * 2 * len(pplan.program.prods), R.route(pplan.program)))
    log(f"kernel: {what} filters x{len(preds)} + project bit-identical")
    return max_err, two_nan_rows, nan_same, timings


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
                log(f"kernel: large filter {name}: {plan.program.n_cols} columns, "
                    f"{len(plan.program.terms)} atoms, {len(plan.program.prods)} products, "
                    f"{plan.program.n_hosts} host masks, stack depth {plan.program.depth()}, "
                    f"plan {8 * R.plan_words(plan.program)} bytes, route {R.route(plan.program)}")
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
        log(f"kernel: n={n} large filters x{len(preds)} + {len(proj)}-value project "
            f"({R.route(pplan.program)}) bit-identical")
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

    _reset_counts()
    t0 = time.perf_counter()
    res = ExecutionPlan(dag, sources).run()
    t_torch = time.perf_counter() - t0
    launches = _counts()["relational"]
    by_instance = _relational_instances()

    _all_identical(ref, res.results, "hot chain")
    if launches <= 0:
        fail("hot chain: the relational kernel was never launched on the torch plane")
    if by_instance["device"] or by_instance["param"] != launches:
        fail(f"hot chain: relational launches did not all take the parameter-plan route: {by_instance}")
    if res.stats.ops_lowered <= 0:
        fail("hot chain: no operator was lowered on the torch plane")
    log(f"main path: hot chain {MAIN_ROWS} rows: numpy {t_numpy:.3f} s, torch {t_torch:.3f} s, "
        f"{res.stats.ops_lowered} ops lowered, {launches} relational launches {by_instance}, "
        f"sinks identical")

    plane = get_plane("torch", device="cuda")
    run = lambda: execute(dag, sources)  # noqa: E731
    wall, copy_s, per_op = _host_breakdown(plane, run)
    ops = ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_op.items(), key=lambda kv: -kv[1]))
    log(f"main path: instrumented torch run {wall:.3f} s; host<->device copies {copy_s:.4f} s "
        f"({100 * copy_s / wall:.2f}%); per operator (s): {ops}")
    busy = _device_profile(run, kinds=(("copy", ("memcpy",)), ("relational", ("relational_kernel",))))
    if busy is None:
        log("main path: device busy time not measured (the profiler saw no device activity)")
    else:
        kinds = busy["by_kind"]
        log(f"main path: profiled torch run {busy['wall_s']:.3f} s; device time: copies "
            f"{kinds['copy']:.4f} s, relational kernel {kinds['relational']:.6f} s, "
            f"other {kinds['other']:.4f} s; device idle share {busy['idle_share']:.4f}")

    # the kernel's timing at the main path's own shapes: f1 over s1's
    # columns, then p1 over the rows f1 keeps
    import torch

    from repro_torch.engine.ops_impl import eval_pred

    s1 = sources["s1"]
    f1 = plane._pred_plan(dag.ops["f1"].get("pred"))
    p1 = plane._proj_plan(dag.ops["p1"].get("cols"))
    kept = s1.mask(eval_pred(dag.ops["f1"].get("pred"), s1))
    fcols = [torch.from_numpy(s1.cols[c]).to("cuda") for c in f1.columns]
    pcols = [torch.from_numpy(kept.cols[c]).to("cuda") for c in p1.columns]
    main_shape = _timed("f1", len(s1), lambda: R.relational(f1.program, fcols),
                        lambda: R.relational_reference(f1.program, fcols),
                        len(s1) * (8 * len(fcols) + 1), len(s1) * 2 * len(f1.program.prods),
                        R.route(f1.program))
    p1_shape = _timed("p1", len(kept), lambda: R.relational(p1.program, pcols),
                      lambda: R.relational_reference(p1.program, pcols),
                      len(kept) * 8 * (len(pcols) + len(p1.program.terms)),
                      len(kept) * 2 * len(p1.program.prods), R.route(p1.program))
    for t in (main_shape, p1_shape):
        _log_timed("main path: relational kernel at ", t)

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
    return {"launches": launches, "instances": by_instance, "t_numpy": t_numpy,
            "t_torch": t_torch, "main_shape": main_shape, "p1_shape": p1_shape}


# -- 5. execute with reuse -----------------------------------------------------


def phase_reuse():
    from repro_torch.engine import ExecutionPlan, InMemoryMaterializationStore, table_digest

    v1 = hot_chain()
    v2 = v1.replace_op(v1.ops["dm"].with_props(entries=(1.0, 2.0, 4.0, 8.0, 16.0)))
    sources = hot_sources(MAIN_ROWS, seed=2)
    store = InMemoryMaterializationStore()

    _reset_counts()
    ExecutionPlan(v1, sources).run(store=store, materialize=True)
    plan2 = ExecutionPlan(v2, sources)
    res2 = plan2.run(store=store, serve_from_store=True, materialize=True)
    launches = _counts()["relational"]
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


# -- 6. verify version pairs, then check each verdict on the card -----------------

# The reference package's verdicts on the four pairs under the three EVs
# (tests/test_torch_verifier.py holds these constants against it), and whether
# the two versions' sinks are equal under Def 2.2 on hot_sources' data: the
# Unknown pairs are decided by execution alone.  Q_const keeps fewer rows
# where x = 5 and g >= 11; Q_dict changes a column that the aggregate drops.
VERIFY_EXPECTED = {"split": True, "implied": True, "const": None, "dict": None}
SINKS_EQUAL = {"split": True, "implied": True, "const": False, "dict": True}
VERIFY_EVS = ("equitas", "spes", "udp")
VERDICT_NAMES = {True: "EQ", False: "NEQ", None: "UNKNOWN"}


def _splice_after(dag, src_id, op):
    """``dag`` with ``op`` spliced onto the one out-link of ``src_id``."""
    from repro_torch.core import dag as D

    link = next(link for link in dag.links if link.src == src_id)
    out = dag.add_op(op).remove_link(link)
    return out.add_link(D.Link(src_id, op.id)).add_link(D.Link(op.id, link.dst, link.dst_port))


def verify_pairs(P):
    """The successor versions of the hot chain ``P`` that the verify phase
    checks: f1's conjunction split into two filters (the linear atom first),
    an implied filter ``x <= 7`` after f1, f1's constant tightened to
    ``x <= 4``, and phase 5's edit of the dictionary matcher."""
    from repro_torch.core import dag as D
    from repro_torch.core.predicates import Pred

    f1 = P.ops["f1"]
    cap, lin = f1.get("pred").children  # x <= 5, -g + 2x + 1 <= 0
    return {
        "split": _splice_after(P.replace_op(f1.with_props(pred=lin)), "f1",
                               D.Operator.make("f1x", D.FILTER, pred=cap)),
        "implied": _splice_after(P, "f1", D.Operator.make("f7", D.FILTER,
                                                          pred=Pred.cmp("x", "<=", 7))),
        "const": P.replace_op(f1.with_props(pred=Pred.and_(Pred.cmp("x", "<=", 4), lin))),
        "dict": P.replace_op(P.ops["dm"].with_props(entries=(1.0, 2.0, 4.0, 8.0, 16.0))),
    }


def phase_verify(card: str):
    from repro_torch.api import Certificate, VeerConfig, tampered, verify
    from repro_torch.engine import execute, sink_results_equal

    P = hot_chain()
    sources = hot_sources(MAIN_ROWS, seed=3)
    config = VeerConfig(evs=VERIFY_EVS)
    _reset_counts()
    t0 = time.perf_counter()
    execute(P, sources)
    t_p = time.perf_counter() - t0
    for name, Q in verify_pairs(P).items():
        t0 = time.perf_counter()
        result = verify(P, Q, config)
        t_verify = time.perf_counter() - t0
        if result.verdict is not VERIFY_EXPECTED[name]:
            fail(f"verify: Q_{name} verdict {result.verdict}, pinned {VERIFY_EXPECTED[name]}")
        cert = result.certificate
        if result.verdict is None:
            if cert is not None:
                fail(f"verify: Q_{name} is Unknown but carries a certificate")
        else:
            report = cert.replay(P=P, Q=Q)
            if not report.ok:
                fail(f"verify: Q_{name} certificate does not replay: {report.summary()}")
            back = Certificate.from_json(cert.to_json())
            if back != cert or back.to_json() != cert.to_json():
                fail(f"verify: Q_{name} certificate does not round-trip through JSON")
            if tampered(cert).replay(P=P, Q=Q).ok:
                fail(f"verify: Q_{name} tampered certificate replays green")
        t0 = time.perf_counter()
        execute(Q, sources)
        t_q = time.perf_counter() - t0
        t0 = time.perf_counter()
        equal = sink_results_equal(P, Q, sources)
        t_check = time.perf_counter() - t0
        if equal is not SINKS_EQUAL[name]:
            fail(f"verify: Q_{name} sinks equal {equal} at {MAIN_ROWS} rows, pinned {SINKS_EQUAL[name]}")
        if result.verdict is True and not equal:
            fail(f"verify: Q_{name} verdict EQ contradicted by execution")
        windows = len(cert.windows) if cert is not None else 0
        log(f"verify: Q_{name} {VERDICT_NAMES[result.verdict]} "
            f"({cert.kind if cert else 'no certificate'}), {windows} windows, "
            f"{result.stats.ev_calls} EV calls; verification {1e3 * t_verify:.3f} ms (host); "
            f"execution at {MAIN_ROWS} rows: P {t_p:.3f} s, Q {t_q:.3f} s; "
            f"sink_results_equal {equal} in {t_check:.3f} s")
    launches = _counts()["relational"]
    if launches <= 0:
        fail("verify: the relational kernel was never launched")
    log(f"verify: {launches} relational launches in the phase; on {card}")
    return launches


# -- 7. version chains: full, reuse and delta execution --------------------------

CHAIN_VERSIONS = 6
DELTA_THRESHOLDS = (80.0, 74.0, 77.0, 71.0, 90.0, 62.0)  # narrow, widen, narrow, widen, narrow


def chain_sources(version, rows: int, seed: int = 0):
    """The reference's exec benchmark data for the synthetic chain: every
    source column drawn from the integers 0..6, as float64."""
    import numpy as np

    from repro_torch.engine.table import Table

    rng = np.random.default_rng(seed)
    return {sid: Table({c: rng.integers(0, 7, rows).astype(np.float64)
                        for c in version.ops[sid].get("schema")},
                       list(version.ops[sid].get("schema")))
            for sid in sorted(version.sources)}


def delta_chain(thresholds=DELTA_THRESHOLDS):
    """``tests/test_delta_exec.py``'s dominated-filter chain: src -> fe (b <
    th, the edited filter) -> fa (a > 2) -> fb (b < 50) -> classifier ->
    aggregate -> sink.  ``fb`` dominates every threshold above 50, so every
    pair is equivalent, and each edit narrows or widens ``fe``."""
    from repro_torch.core import dag as D
    from repro_torch.core.predicates import Pred

    def build(th):
        ops = [
            D.Operator.make("src", D.SOURCE, schema=("a", "b", "c")),
            D.Operator.make("fe", D.FILTER, pred=Pred.cmp("b", "<", th)),
            D.Operator.make("fa", D.FILTER, pred=Pred.cmp("a", ">", 2)),
            D.Operator.make("fb", D.FILTER, pred=Pred.cmp("b", "<", 50)),
            D.Operator.make("cl", D.CLASSIFIER, col="a", out="label", model="m", classes=5),
            D.Operator.make("agg", D.AGGREGATE, group_by=("label",),
                            aggs=(("sum", "a", "sa"), ("count", "*", "n"))),
            D.Operator.make("sink", D.SINK, semantics=D.BAG),
        ]
        path = [o.id for o in ops]
        dag = D.DataflowDAG(ops, [D.Link(a, b) for a, b in zip(path, path[1:])])
        dag.validate()
        return dag

    return [build(th) for th in thresholds]


def delta_sources(rows: int, seed: int = 0):
    """``tests/test_delta_exec.py``'s table: a in 0..9, b uniform on [0, 100),
    c in -5..4."""
    import numpy as np

    from repro_torch.engine.table import Table

    rng = np.random.default_rng(seed)
    return {"src": Table({"a": rng.integers(0, 10, rows).astype(np.float64),
                          "b": rng.uniform(0, 100, rows),
                          "c": rng.integers(-5, 5, rows).astype(np.float64)}, ["a", "b", "c"])}


class _SessionClock:
    """Host seconds a session spends in its verifier
    (``session.veer.verify_with_evidence``) and in its store's writes
    (``session.store.put``: each table's content hash and the write), and
    the delta runs that raised ``DeltaUnsupported``.  It wraps only public
    names, adds no synchronization, and every mode gets the same clock, so
    wall times compare across modes."""

    def __init__(self, session):
        from repro_torch.engine import delta as delta_engine

        self.verify = self.store = 0.0
        self.unsupported = 0
        self._undo = []

        def timed(obj, name, field):
            fn = getattr(obj, name)

            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    setattr(self, field, getattr(self, field) + time.perf_counter() - t0)
            setattr(obj, name, wrapper)
            self._undo.append((obj, name))

        timed(session.veer, "verify_with_evidence", "verify")
        timed(session.store, "put", "store")
        run_delta = delta_engine.execute_delta

        def counted(*a, **kw):
            try:
                return run_delta(*a, **kw)
            except delta_engine.DeltaUnsupported:
                self.unsupported += 1
                raise
        delta_engine.execute_delta = counted
        self._undo.append((delta_engine, "execute_delta", run_delta))

    def close(self):
        for entry in reversed(self._undo):
            if len(entry) == 3:
                setattr(*entry)
            else:  # instance attributes: the class's methods show again
                delattr(*entry)

    def snapshot(self):
        return {"verify": self.verify, "store": self.store, "unsupported": self.unsupported}


def _run_session(tag, mode, versions, sources, store):
    """Submit every version to a torch-plane session on the card in
    ``mode``; log each version and return its reports, figures and the
    relational launches each submit made."""
    from repro_torch.api import VeerConfig
    from repro_torch.service import VersionChainSession

    session = VersionChainSession(config=VeerConfig(evs=VERIFY_EVS, exec_mode=mode),
                                  materialization_store=store)
    if session.plane != "torch" or session.device != "cuda":
        fail(f"chain: the session runs on {session.plane}/{session.device}, not torch/cuda")
    clock = _SessionClock(session)
    rows = []
    try:
        for k, v in enumerate(versions):
            before, launches = clock.snapshot(), _counts()["relational"]
            t0 = time.perf_counter()
            r = session.submit(v, sources=sources)
            wall = time.perf_counter() - t0
            after = clock.snapshot()
            e = r.exec_stats
            row = {"mode": mode, "report": r, "wall": wall,
                   "launches": _counts()["relational"] - launches,
                   **{f: after[f] - before[f] for f in after}}
            rows.append(row)
            log(f"chain: {tag} {mode} v{k}: {wall:.3f} s wall, verify {1e3 * row['verify']:.3f} ms, "
                f"store writes {1e3 * row['store']:.3f} ms (host); ops executed {e.ops_executed} / "
                f"reused {e.ops_reused} / delta {e.ops_delta} of {e.ops_total}, "
                f"{e.delta_rows_processed} delta rows, {row['launches']} relational launches, "
                f"DeltaUnsupported {row['unsupported']}"
                + (f"; {VERDICT_NAMES[r.verdict]}" if k else ""))
    finally:
        clock.close()
    return rows


def _check_certified(tag, mode, versions, rows):
    """Every successor EQ, certified, and its certificate green against the
    pair, also after a round trip through JSON.  Logs the host time of
    deriving each pair's reuse frontier from its certificate (the replay a
    reuse or delta submit makes), timed here, apart from the session."""
    from repro_torch.api import Certificate, compute_reuse_frontier

    frontier_ms = []
    for k in range(1, len(versions)):
        r = rows[k]["report"]
        if r.verdict is not True or not r.certified:
            fail(f"chain: {tag} {mode} v{k} verdict {r.verdict}, certified {r.certified}")
        for cert in (r.certificate, Certificate.from_json(r.certificate.to_json())):
            report = cert.replay(P=versions[k - 1], Q=versions[k])
            if not report.ok:
                fail(f"chain: {tag} {mode} v{k} certificate does not replay: {report.summary()}")
        t0 = time.perf_counter()
        compute_reuse_frontier(r.certificate, versions[k - 1], versions[k])
        frontier_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"chain: {tag} {mode}: every successor EQ and certified, its certificate green; "
        f"frontier derivation v1..v{len(versions) - 1} (apart from the session): "
        + ", ".join(f"{ms:.3f}" for ms in frontier_ms) + " ms")


def _identical_to(tag, want, rows):
    for k, row in enumerate(rows):
        _all_identical(want[k], row["report"].results, f"chain: {tag} v{k} ({row['mode']})")


def phase_chain(card: str):
    """Version chains on the card through ``VersionChainSession`` at the
    torch plane: (a) the synthetic heavy chain in full and reuse mode, (b) the
    dominated-filter chain in delta and full mode, (c) ``ReuseManager`` on a
    disk store.  Every sink against a numpy-plane run of its version."""
    import tempfile

    from repro_torch.engine import (
        InMemoryMaterializationStore,
        execute,
        get_plane,
        tables_identical,
    )
    from repro_torch.kernels import relational as R
    from repro_torch.reuse import ReuseManager
    from repro_torch.service.synthetic import make_chain

    plane = get_plane("torch", device="cuda")
    t_phase = time.perf_counter()
    _reset_counts()

    # (a) the synthetic chain: 5 branches of 1M rows each
    versions = make_chain(CHAIN_VERSIONS, heavy=True)
    sources = chain_sources(versions[0], MAIN_ROWS)
    t0 = time.perf_counter()
    want = [execute(v, sources, plane="numpy") for v in versions]
    t_numpy_a = time.perf_counter() - t0
    runs = {}
    for mode in ("full", "reuse"):
        runs[mode] = _run_session("synthetic", mode, versions, sources,
                                  InMemoryMaterializationStore())
        _identical_to("synthetic", want, runs[mode])
        _check_certified("synthetic", mode, versions, runs[mode])
    for k in range(1, CHAIN_VERSIONS):
        full, reuse = runs["full"][k]["report"], runs["reuse"][k]["report"]
        if full.exec_stats.ops_reused != 0:
            fail(f"chain: synthetic full v{k} reused {full.exec_stats.ops_reused} ops")
        if reuse.exec_stats.ops_reused <= 0:
            fail(f"chain: synthetic reuse v{k} reused no operator")
    log(f"chain: synthetic chain, {len(sources)} sources x {MAIN_ROWS} rows: numpy plane "
        f"{t_numpy_a:.3f} s for {CHAIN_VERSIONS} versions; sinks identical in both modes")

    # (b) the dominated-filter chain, delta against full
    dversions = delta_chain()
    dsources = delta_sources(MAIN_ROWS, seed=4)
    t0 = time.perf_counter()
    dwant = [execute(v, dsources, plane="numpy") for v in dversions]
    t_numpy_b = time.perf_counter() - t0
    for mode in ("delta", "full"):
        runs[f"dominated-{mode}"] = _run_session("dominated", mode, dversions, dsources,
                                                 InMemoryMaterializationStore())
        _identical_to("dominated", dwant, runs[f"dominated-{mode}"])
        _check_certified("dominated", mode, dversions, runs[f"dominated-{mode}"])
    delta_launches = 0
    for k in range(1, len(dversions)):
        e = runs["dominated-delta"][k]["report"].exec_stats
        if e.ops_delta <= 0 or e.delta_rows_processed <= 0:
            fail(f"chain: dominated delta v{k}: ops_delta {e.ops_delta}, "
                 f"{e.delta_rows_processed} delta rows")
        if runs["dominated-full"][k]["report"].exec_stats.ops_delta:
            fail(f"chain: dominated full v{k} took the delta tier")
        delta_launches += runs["dominated-delta"][k]["launches"]
    if delta_launches <= 0:
        fail("chain: the delta runs launched no relational kernel")
    log(f"chain: dominated-filter chain {MAIN_ROWS} rows: numpy plane {t_numpy_b:.3f} s for "
        f"{len(dversions)} versions; delta sinks identical to numpy and to full mode; "
        f"{delta_launches} relational launches in the delta runs")

    # (c) ReuseManager on a disk store: two versions of the synthetic chain
    rversions = make_chain(2, heavy=True)
    rsources = chain_sources(rversions[0], MAIN_ROWS, seed=5)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        rm = ReuseManager(os.path.join(tmp, "store"))
        if rm.plane != "torch" or rm.device != "cuda":
            fail(f"chain: the reuse manager runs on {rm.plane}/{rm.device}")
        walls = []
        for v in rversions:
            t0 = time.perf_counter()
            got = rm.submit(v, rsources)
            walls.append(time.perf_counter() - t0)
        # the phase's count ends with the submits: the comparison run below
        # is the check's own
        launches = _counts()["relational"]
        full = execute(rversions[1], rsources)
        for s, table in full.items():
            if not tables_identical(table, got[s]):
                fail(f"chain: reuse manager sink {s} differs from a full torch-plane run")
        st = rm.stats
        if st.sink_hits + st.interior_hits < 1:
            fail(f"chain: the reuse manager served no table: {st}")
        log(f"chain: reuse manager (disk store) v0 {walls[0]:.3f} s, v1 {walls[1]:.3f} s; "
            f"sink hits {st.sink_hits}, interior hits {st.interior_hits}, certified reuses "
            f"{st.certified_reuses}, ops executed {st.ops_executed} / reused {st.ops_reused}, "
            f"verify {1e3 * st.verify_time:.3f} ms; sinks identical to a full torch-plane run")

    if launches <= 0:
        fail("chain: the relational kernel was never launched")
    log(f"chain: {launches} relational launches in the phase; phase {time.perf_counter() - t_phase:.1f} s; "
        f"on {card}")

    # the delta boundary mask apart from the runs (after the count is read:
    # these launches are not the chain's): b < 74 over the 1M source rows,
    # through the plane (column upload, kernel, mask download) against the
    # host's eval_pred, and the kernel alone against its plain version
    import numpy as np
    import torch

    from repro_torch.engine.ops_impl import eval_pred

    pred = dversions[1].ops["fe"].get("pred")
    table = dsources["src"]
    if not np.array_equal(np.asarray(plane.pred_mask(pred, table), dtype=bool), eval_pred(pred, table)):
        fail("chain: the plane's boundary mask differs from eval_pred")
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        np.asarray(plane.pred_mask(pred, table), dtype=bool)
        walls.append(1e3 * (time.perf_counter() - t0))
    fe = plane._pred_plan(pred)
    bcol = [torch.from_numpy(table.cols[c]).to(plane.device) for c in fe.columns]
    if not torch.equal(R.relational(fe.program, bcol), R.relational_reference(fe.program, bcol)):
        fail("chain: the boundary mask's kernel differs from its plain version")
    n = MAIN_ROWS
    mask_shape = _timed("delta boundary mask", n, lambda: R.relational(fe.program, bcol),
                        lambda: R.relational_reference(fe.program, bcol),
                        n * (8 * len(bcol) + 1), n * 2 * len(fe.program.prods), R.route(fe.program))
    _log_timed("chain: relational kernel at ", mask_shape)
    log(f"chain: the boundary mask through the plane's pred_mask, {len(bcol)} column(s) of {n} rows "
        f"uploaded and the mask brought back: {statistics.median(walls):.4f} ms wall (median of 7), "
        f"equal to eval_pred; the kernel alone equal to its plain version")

    # what phase 7b holds the service and the fleet to: (a) in reuse mode and
    # (b) in delta mode, each version's sinks from this in-process run
    served = {
        "synthetic": (versions, sources, [row["report"].results for row in runs["reuse"]]),
        "dominated": (dversions, dsources,
                      [row["report"].results for row in runs["dominated-delta"]]),
    }
    return {"launches": launches, "delta_launches": delta_launches, "served": served}


# -- 6b. a SessionGenerator corpus under the full roster, guided and not ----------

CORPUS_SESSIONS = 4  # of smoke_config(0)'s 8: 100 pairs, not 200


def _timed_evs(ev_classes, table):
    """Count and time every ``check`` of the EV classes (class attributes,
    restored by the returned function)."""
    undo = []
    for cls in ev_classes:
        orig = cls.check

        def check(self, qp, _orig=orig):
            t0 = time.perf_counter()
            try:
                return _orig(self, qp)
            finally:
                row = table.setdefault(self.name, [0, 0.0])
                row[0] += 1
                row[1] += time.perf_counter() - t0
        cls.check = check
        undo.append((cls, orig))

    def restore():
        for cls, orig in undo:
            cls.check = orig
    return restore


def phase_verify_corpus(card: str):
    """A seeded corpus of the port's ``SessionGenerator`` (``smoke_config(0)``,
    cut to ``CORPUS_SESSIONS`` sessions) verified on the card's host under
    the full four-EV roster, unguided and with ``guidance="model"``."""
    import statistics as st

    from repro_torch.api import DEFAULT_EV_NAMES, VeerConfig, default_registry, verify
    from repro_torch.workload import EXPECTED_EQ, SessionGenerator, smoke_config

    cfg = smoke_config(0).replace(sessions=CORPUS_SESSIONS, clients=CORPUS_SESSIONS)
    pairs = [(s.versions[p.index - 1], s.versions[p.index], p)
             for s in SessionGenerator(cfg).generate() for p in s.pairs]
    if DEFAULT_EV_NAMES != ("equitas", "spes", "udp", "jaxpr"):
        fail(f"verify-corpus: the roster is {DEFAULT_EV_NAMES}")
    ev_classes = {type(ev) for ev in default_registry().build()}
    out = {}
    for guidance in ("none", "model"):
        config = VeerConfig(max_decompositions=cfg.max_decompositions, guidance=guidance)
        per_ev = {}
        restore = _timed_evs(ev_classes, per_ev)
        walls, results = [], []
        try:
            for P, Q, planned in pairs:
                t0 = time.perf_counter()
                results.append(verify(P, Q, config, mapping=planned.mapping))
                walls.append(time.perf_counter() - t0)
        finally:
            restore()
        for (P, Q, planned), r in zip(pairs, results):
            if r.verdict is not None and not r.certificate.replay(P=P, Q=Q).ok:
                fail(f"verify-corpus: {guidance} pair {planned.index} certificate does not replay")
            if planned.expected == EXPECTED_EQ and r.verdict is False:
                fail(f"verify-corpus: a {planned.kind} pair judged NEQ ({guidance})")
        verdicts = {name: sum(r.verdict is v for r in results) for v, name in VERDICT_NAMES.items()}
        firsts = [r.stats.decompositions_to_first_certificate for r in results]
        out[guidance] = {"results": results, "firsts": firsts}
        log(f"verify-corpus: {guidance}: {len(pairs)} pairs {verdicts}; verification per pair "
            f"median {1e3 * st.median(walls):.3f} ms, mean {1e3 * st.mean(walls):.3f}, max "
            f"{1e3 * max(walls):.3f} ms, total {sum(walls):.3f} s (host); EV calls "
            f"{sum(r.stats.ev_calls for r in results)}, ev_time "
            f"{sum(r.stats.ev_time for r in results):.3f} s")
        for name in DEFAULT_EV_NAMES:
            calls, secs = per_ev.get(name, (0, 0.0))
            log(f"verify-corpus: {guidance}: EV {name}: {calls} checks, {secs:.3f} s"
                + (f", {1e3 * secs / calls:.3f} ms a check" if calls else ""))
        if not per_ev.get("jaxpr", (0,))[0]:
            fail(f"verify-corpus: the traced EV was never asked ({guidance})")
    for (P, Q, planned), u, g in zip(pairs, out["none"]["results"], out["model"]["results"]):
        if None not in (u.verdict, g.verdict) and u.verdict is not g.verdict:
            fail(f"verify-corpus: guidance flipped pair {planned.index}: {u.verdict} vs {g.verdict}")
    both = [(u, g) for u, g in zip(out["none"]["firsts"], out["model"]["firsts"])
            if u is not None and g is not None]
    log(f"verify-corpus: decompositions explored to the first certificate over the "
        f"{len(both)} pairs both certified by search: unguided {sum(u for u, _ in both)} "
        f"(median {st.median(u for u, _ in both) if both else 0}), guided "
        f"{sum(g for _, g in both)} (median {st.median(g for _, g in both) if both else 0}); "
        f"on {card}")


# -- 7b. the verification service and fleet on the card ---------------------------

SERVICE_THREADS = 3


def _shard_clients(first_versions):
    """Client ids for the service and the fleet: one per chain of
    ``first_versions`` (name -> first version), picked so that the fleet's
    ring puts the first two on different workers."""
    from repro_torch.service import ConsistentHashRing, shard_key

    ring = ConsistentHashRing(2)
    names, taken = {}, []
    for tag, v0 in first_versions.items():
        for i in range(256):
            cid = f"{tag}-{i}"
            shard = ring.node(shard_key(cid, v0))
            if len(taken) == 1 and shard == taken[0]:
                continue  # the second client goes to the other worker
            names[cid] = (tag, shard)
            taken.append(shard)
            break
    if len(set(taken[:2])) != 2:
        fail("service: no client ids spread over both workers")
    return names


def _check_served(where, clients, futures, served):
    """Every sink identical to phase 7's in-process run of the version, and
    every successor EQ with a certificate that replays."""
    from repro_torch.engine import tables_identical

    for cid, (tag, _) in clients.items():
        versions, _, want = served[tag]
        for k, f in enumerate(futures[cid]):
            r = f.result(timeout=600)
            for s, table in want[k].items():
                if not tables_identical(table, r.results[s]):
                    fail(f"service: {where} {cid} v{k} sink {s} differs from phase 7's run")
            if k == 0:
                continue
            if r.verdict is not True or r.certificate is None:
                fail(f"service: {where} {cid} v{k} verdict {r.verdict}, certificate {r.certificate}")
            if not r.certificate.replay(P=versions[k - 1], Q=versions[k]).ok:
                fail(f"service: {where} {cid} v{k} certificate does not replay")
            e = r.exec_stats
            if tag == "dominated" and e.ops_delta <= 0:
                fail(f"service: {where} {cid} v{k} did not take the delta tier")
            if tag == "synthetic" and (e.ops_delta or not (e.ops_reused or r.reused)):
                fail(f"service: {where} {cid} v{k}: ops_delta {e.ops_delta}, "
                     f"ops_reused {e.ops_reused} (reuse mode expected)")


def _submit_round_robin(svc, clients, served, latencies):
    futures = {cid: [] for cid in clients}
    depth = max(len(served[tag][0]) for tag, _ in clients.values())
    for k in range(depth):
        for cid, (tag, _) in clients.items():
            versions, sources, _ = served[tag]
            if k >= len(versions):
                continue
            t0 = time.perf_counter()
            f = svc.submit(cid, versions[k], sources=sources, timeout=600)
            f.add_done_callback(
                lambda _f, cid=cid, k=k, t0=t0: latencies.__setitem__((cid, k), time.perf_counter() - t0))
            futures[cid].append(f)
    return futures


def _log_latencies(where, clients, latencies):
    for cid in clients:
        row = [latencies[key] for key in sorted(k for k in latencies if k[0] == cid)]
        log(f"service: {where} {cid}: submit to result per version "
            + ", ".join(f"{x:.3f}" for x in row) + " s")


def phase_service(card: str, served):
    """(a) ``VerificationService`` threads and (b) a 2-worker
    ``VerificationFleet`` on the file tier, both on ``device="cuda"``,
    serving two clients of phase 7's synthetic chain and one of its
    dominated-filter chain at 1,000,000 rows a source."""
    import shutil
    import tempfile
    from multiprocessing.reduction import ForkingPickler

    from repro_torch.api import VeerConfig
    from repro_torch.engine import InMemoryMaterializationStore
    from repro_torch.service import VerificationFleet, VerificationService

    t_phase = time.perf_counter()
    # exec_mode "delta": the dominated chain's edits take the delta tier; the
    # synthetic chain's are not delta-amenable and run the seeded reuse path
    config = VeerConfig(evs=VERIFY_EVS, exec_mode="delta")
    clients = _shard_clients({"synthetic": served["synthetic"][0][0],
                              "synthetic2": served["synthetic"][0][0],
                              "dominated": served["dominated"][0][0]})
    clients = {cid: ("synthetic" if tag.startswith("synthetic") else tag, shard)
               for cid, (tag, shard) in clients.items()}

    # (a) the service: threads of this process, one CUDA context
    _reset_counts()
    latencies = {}
    t0 = time.perf_counter()
    with VerificationService(config=config, workers=SERVICE_THREADS, device="cuda",
                             materialization_store=InMemoryMaterializationStore()) as svc:
        futures = _submit_round_robin(svc, clients, served, latencies)
        report = svc.drain()
    t_service = time.perf_counter() - t0
    launches = _counts()["relational"]
    if report.errors:
        fail(f"service: the service reported errors: {report.errors}")
    _check_served("service", clients, futures, served)
    if launches <= 0:
        fail("service: the service's sessions launched no relational kernel")
    _log_latencies("service", clients, latencies)
    log(f"service: VerificationService, {SERVICE_THREADS} threads, {len(clients)} clients: "
        f"{t_service:.3f} s wall, {launches} relational launches, {report.reused_pairs} pairs "
        f"reused; every sink identical to phase 7's, every certificate replayed")

    # what crossing into a worker costs: each submit's message pickled as the
    # fleet's queue pickles it, and unpickled, measured apart from the fleet;
    # an unpickled table is a new object, so a worker hashes its sources
    # again (table_digest memoizes per object): that too, once per message
    from repro_torch.engine.store import table_digest

    pickle_s = unpickle_s = pickle_mb = rehash_s = 0.0
    for cid, (tag, _) in clients.items():
        versions, sources, _ = served[tag]
        for k, v in enumerate(versions):
            t1 = time.perf_counter()
            blob = ForkingPickler.dumps(("job", k, cid, v, None, sources))
            t2 = time.perf_counter()
            msg = ForkingPickler.loads(blob)
            t3 = time.perf_counter()
            for table in msg[5].values():
                table_digest(table)
            rehash_s += time.perf_counter() - t3
            unpickle_s += t3 - t2
            pickle_s += t2 - t1
            pickle_mb += len(blob) / 1e6
            del blob, msg

    # (b) the fleet: two worker processes, each with its own CUDA context,
    # started after every earlier phase has used the card in this process
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tier_dir = tempfile.mkdtemp(prefix="service-tier-", dir=os.path.join(ROOT, "build"))
    latencies = {}
    try:
        t0 = time.perf_counter()
        fleet = VerificationFleet(2, config=config.replace(shared_tier="remote", tier_dir=tier_dir),
                                  device="cuda")
        try:
            futures = _submit_round_robin(fleet, clients, served, latencies)
            freport = fleet.drain()
            t_fleet = time.perf_counter() - t0
        finally:
            fleet.close()
        t_close = time.perf_counter() - t0 - t_fleet
        if freport.errors:
            fail(f"service: the fleet reported errors: {freport.errors}")
        _check_served("fleet", clients, futures, served)
        per_worker = [ws["relational_launches"] if ws else None for ws in freport.worker_stats]
        for cid, (_, shard) in clients.items():
            if not per_worker[shard]:
                fail(f"service: fleet worker {shard} executed {cid} but reports "
                     f"{per_worker[shard]} relational launches")
        _log_latencies("fleet", clients, latencies)
        ts = freport.tier_stats
        log(f"service: VerificationFleet, 2 workers ({fleet._ctx.get_start_method()}), file tier: "
            f"{t_fleet:.3f} s wall to "
            f"the drain, close {t_close:.3f} s; relational launches per worker {per_worker}; "
            f"{freport.recoveries} recoveries; pairs served by the tier "
            f"{freport.pair_cache_stats.get('tier_hits', 0)}, tables by the tier "
            f"{freport.store_stats.get('tier_hits', 0)}")
        log(f"service: crossing into the workers: {pickle_mb:.1f} MB pickled over "
            f"{sum(len(served[t][0]) for t, _ in clients.values())} submits, {pickle_s:.3f} s to "
            f"pickle, {unpickle_s:.3f} s to unpickle and {rehash_s:.3f} s to hash the unpickled "
            f"sources again (measured apart from the fleet); tier "
            f"payload writes {ts.get('payload_bytes_written', 0) / 1e6:.1f} MB in "
            f"{ts.get('payload_write_seconds', 0.0):.3f} s (the workers' own clocks)")
    finally:
        shutil.rmtree(tier_dir, ignore_errors=True)
    log(f"service: phase {time.perf_counter() - t_phase:.1f} s; on {card}")
    return {"launches": launches, "fleet_launches": sum(x or 0 for x in per_worker)}


# -- 8. the LLM kernels against their plain versions -----------------------------

# Logits of the kernel path against the plain path, bf16, atol = rtol: fixed
# before the first run.  At full depth with random weights the model amplifies
# any rounding difference, so no implementation meets it free running: the plain
# path against itself summed in another order parts by ~0.33 (PERF.md, section 6).
# The distance is reported in units of it; the gates are each kernel on the main
# path's own tensors at its tolerance, and the end-to-end logits (forward, and
# decode against forward) within CONTROL_FACTOR times the plain path's own
# reordering or decode distance.
LOGIT_TOL = 2e-2
CONTROL_FACTOR = 2.0
PREFILL = dict(B=2, S=4096, T=4096, H=32, KV=8, D=128)

# (name, shape, dtype, masks): the prefill shape first, then every mask and tail
FLASH_CASES = (
    ("prefill causal", PREFILL, "bf16", dict(causal=True)),
    ("window 1024", PREFILL, "bf16", dict(causal=True, window=1024)),
    ("chunk 1024", PREFILL, "bf16", dict(causal=True, chunk=1024)),
    ("q_offset 3072, S<T", dict(PREFILL, S=1024), "bf16", dict(causal=True, q_offset=3072)),
    ("not causal", dict(PREFILL, B=1, S=2048, T=2048), "bf16", dict(causal=False)),
    ("tail S=T=4095", dict(PREFILL, S=4095, T=4095), "bf16", dict(causal=True)),
    ("fp32 small", dict(B=2, S=512, T=512, H=8, KV=2, D=128), "fp32", dict(causal=True)),
    ("fp32 window, tail", dict(B=1, S=333, T=333, H=4, KV=1, D=64), "fp32", dict(causal=True, window=100)),
)
# (name, x shape, dtype): the prefill's rows first
RMS_CASES = (
    ("prefill rows", (2, 4096, 4096), "bf16"),
    ("decode rows", (4, 1, 4096), "bf16"),
    ("fp32", (2, 4096, 4096), "fp32"),
    ("gemma3 D=5376", (4096, 5376), "bf16"),
    ("command-r D=12288", (2048, 12288), "bf16"),
    ("odd D=4097", (1000, 4097), "fp32"),
    ("mamba2 d_model D=2560", (2, 4096, 2560), "bf16"),
    ("mamba2 gated D=5120", (2, 4096, 5120), "bf16"),
)
# The tensor-core instances against the mirrors of their own arithmetic:
# every element of the output within two bf16 units in the last place of the
# mirror's value plus MIRROR_ATOL, but for at most MIRROR_STRAYS of the
# elements, which must be within 2e-2 (atol = rtol).  The two sum in other
# orders, so a bf16 rounding may fall the other way: of an output, or of an
# operand the kernel rounds to bf16 (the SSD's S_in and CB o L o dt, whose
# one-ulp step moves an output by up to ~1e-2).  An indexing fault moves whole
# rows or tiles.  The SSD final state within MIRROR_STATE_TOL (atol = rtol;
# both take the cumulative sums in one order).
MIRROR_ATOL = 1e-3
MIRROR_STRAYS = 1e-5
MIRROR_STATE_TOL = 1e-5
# the SSD scan: mamba2-2.7b's prefill shape first (2 prompts of 4096 tokens,
# 80 heads of 64, one group, state 128, chunks of 256)
SSD_MAIN = dict(B=2, L=4096, H=80, P=64, G=1, N=128, chunk=256)
# (name, shape, dtype, with an initial state)
SSD_CASES = (
    ("prefill", SSD_MAIN, "bf16", False),
    ("single chunk L=256", dict(SSD_MAIN, L=256), "bf16", False),
    ("G=2, H/G=4", dict(SSD_MAIN, L=1024, H=8, G=2), "bf16", False),
    ("initial state", dict(SSD_MAIN, L=1024), "bf16", True),
    ("B=1", dict(SSD_MAIN, B=1), "bf16", False),
    ("chunk 128, G=2, initial state", dict(SSD_MAIN, L=1024, H=8, G=2, chunk=128), "bf16", True),
    ("chunk 64, N=64", dict(SSD_MAIN, L=1024, H=16, N=64, chunk=64), "bf16", False),
    ("fp32 test shape 1", dict(B=1, L=64, H=2, P=8, G=1, N=16, chunk=16), "fp32", False),
    ("fp32 test shape 2", dict(B=2, L=128, H=4, P=16, G=2, N=32, chunk=32), "fp32", False),
    ("fp32 test shape 3", dict(B=1, L=96, H=8, P=8, G=4, N=8, chunk=32), "fp32", False),
)


def _ssd_tols(dtype, chunk):
    """(tolerance of y, of the fp32 final state), atol = rtol: fp32 1e-5
    (``tests/test_kernels.py``), bf16 y 2e-2; the state 1e-5, or 1e-4 at
    chunks of 256, whose cumulative sums of dt * A reach ~1e2 and differ
    between the plain version's parallel ``torch.cumsum`` and the kernel's
    in-order sum by a few units in their last place (~1e-5 of each decay)."""
    import torch

    return (1e-5 if dtype == torch.float32 else 2e-2), (1e-4 if chunk >= 256 else 1e-5)


def _ssd_bound_ms(x, Bm, chunk, nbytes):
    """The least time of one SSD call: ``nbytes`` over the memory rate, or
    its products over the bf16 tensor-core rate (fp32 inputs: the CUDA
    cores' fp32 rate).  Products counted once each: C.B^T per (batch, chunk,
    group) on the causal half, and per (batch, head, chunk) the intra-chunk
    product on the causal half, C.state and the state update."""
    import torch

    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, pairs = L // chunk, chunk * (chunk + 1) // 2
    flops = 2 * N * pairs * Bsz * nc * G + Bsz * H * nc * (2 * P * pairs + 4 * chunk * N * P)
    rate = BF16_TENSOR_FLOP_PER_S if x.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return _bound_ms(nbytes, flops, rate) + (flops,)


def _dtype(name):
    import torch

    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


def _randn(gen, shape, dtype, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _visible_pairs(S, T, causal=True, window=None, chunk=None, q_offset=0):
    """(q, k) pairs a mask leaves visible, per batch and head: the work the
    kernel must do on these inputs."""
    import numpy as np

    q = np.arange(S, dtype=np.int64) + q_offset
    lo = np.zeros(S, dtype=np.int64)
    hi = np.full(S, T - 1, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, q)
    if window is not None:
        lo = np.maximum(lo, q - window + 1)
    if chunk is not None:
        lo = np.maximum(lo, (q // chunk) * chunk)
        hi = np.minimum(hi, (q // chunk) * chunk + chunk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _bf16_ulp_ok(got, want) -> bool:
    """Every value within one bf16 unit in the last place of the plain one."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool(((got.float() - w).abs() <= ulp).all())


def _mirror_gap(got, want):
    """(max abs difference, elements beyond two bf16 units in the last place
    of ``want`` plus MIRROR_ATOL, whether that is within the tight gate): a
    tensor-core kernel against the plain mirror of its own arithmetic
    (``ref.flash_attention_tc_reference`` / ``ref.ssd_chunked_reference``)."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    d = (got.float() - w).abs()
    beyond = int((d > 2 * ulp + MIRROR_ATOL).sum())
    near = bool(torch.allclose(got.float(), w, atol=2e-2, rtol=2e-2))
    ok = beyond <= MIRROR_STRAYS * d.numel() and near
    return float(d.max()), beyond, ok


def _one_instance(wrapper, dtype, call):
    """Run ``call`` and fail unless it launched the instance of ``dtype``
    once: the tensor-core one for bf16, the CUDA-core one for fp32."""
    import torch

    before = (wrapper.launches_tc, wrapper.launches_fp32)
    out = call()
    want = (before[0] + 1, before[1]) if dtype == torch.bfloat16 else (before[0], before[1] + 1)
    if (wrapper.launches_tc, wrapper.launches_fp32) != want:
        fail(f"{wrapper.__name__}: a {dtype} call launched tc/fp32 "
             f"{(wrapper.launches_tc - before[0], wrapper.launches_fp32 - before[1])}")
    return out


def phase_llm_kernels(seed: int):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    _, RMS, FA, SS = _kernel_modules()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 100)
    out = {}

    max_err = 0.0
    for name, shape, dt, masks in FLASH_CASES:
        B, S, T, H, KV, D = (shape[k] for k in ("B", "S", "T", "H", "KV", "D"))
        dtype = _dtype(dt)
        q = _randn(gen, (B, S, H, D), dtype, 0.5)
        k = _randn(gen, (B, T, KV, D), dtype, 0.5)
        v = _randn(gen, (B, T, KV, D), dtype, 0.5)
        got = _one_instance(FA.flash_attention, dtype, lambda: FA.flash_attention(q, k, v, **masks))
        want = ref.flash_attention_reference(q, k, v, **masks)
        torch.cuda.synchronize()
        tol = 2e-6 if dt == "fp32" else 2e-2
        err = float((got.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"flash attention {name}: kernel differs from the plain version "
                 f"(max abs {err:.3e}, tolerance {tol})")
        mirror = ""
        if dt == "bf16":
            gap, beyond, ok = _mirror_gap(got, ref.flash_attention_tc_reference(q, k, v, **masks))
            if not ok:
                fail(f"flash attention {name}: the tensor-core kernel parts from its mirror: "
                     f"{beyond} elements beyond two bf16 ulps + {MIRROR_ATOL} (max abs {gap:.3e})")
            mirror = (f"; against its mirror {gap:.3e}, {beyond} elements beyond two ulps + "
                      f"{MIRROR_ATOL}")
        log(f"llm-kernels: flash attention {name} {dt} B={B} S={S} T={T} H={H} KV={KV} D={D} "
            f"{masks}: max abs err {err:.3e} (tol {tol}){mirror}")
        if name == "prefill causal":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
            pairs = B * H * _visible_pairs(S, T, **masks)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
            bound, by = _bound_ms(nbytes, 4 * D * pairs, BF16_TENSOR_FLOP_PER_S)
            timing = {
                "ms": _time_ms(lambda: FA.flash_attention(q, k, v, **masks)),
                "plain_ms": _time_ms(lambda: ref.flash_attention_reference(q, k, v, **masks), reps=5),
                "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                "bound_ms": bound, "bound_by": by,
            }
            log(f"llm-kernels: flash attention at the prefill shape: kernel {timing['ms']:.4f} ms, "
                f"plain {timing['plain_ms']:.4f} ms, scaled_dot_product_attention "
                f"{timing['library_ms']:.4f} ms (max abs {lib_err:.3e} from the plain version), "
                f"bound {bound:.4f} ms ({by}; {pairs} visible pairs, {nbytes} bytes); "
                f"kernel at {4 * D * pairs / timing['ms'] / 1e9:.2f} TFLOP/s")
        del q, k, v, got, want
    out["flash_attention"] = dict(timing, max_abs_err=max_err)

    max_err = 0.0
    for name, shape, dt in RMS_CASES:
        dtype = _dtype(dt)
        x = _randn(gen, shape, dtype)
        w = _randn(gen, shape[-1:], torch.float32)
        got = RMS.rmsnorm(x, w, 1e-5)
        want = ref.rmsnorm_reference(x, w, 1e-5)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        ok = (torch.allclose(got, want, atol=1e-6, rtol=1e-6) if dt == "fp32"
              else _bf16_ulp_ok(got, want))
        if not ok:
            fail(f"rmsnorm {name}: kernel differs from the plain version (max abs {err:.3e})")
        log(f"llm-kernels: rmsnorm {name} {dt} {shape}: max abs err {err:.3e} "
            f"({'1e-6' if dt == 'fp32' else 'one bf16 ulp'})")
        if name == "prefill rows" or name.startswith("mamba2"):
            D = shape[-1]
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
            bound, by = _bound_ms(nbytes, 4 * x.numel(), FP32_FLOP_PER_S)
            # the same inputs (fp32 weight), and the fused path, which wants the
            # weight in x's dtype (logged only: its weight is rounded to bf16)
            w_x = w.to(dtype)
            timing = {
                "ms": _time_ms(lambda: RMS.rmsnorm(x, w, 1e-5)),
                "plain_ms": _time_ms(lambda: ref.rmsnorm_reference(x, w, 1e-5)),
                "library_ms": _time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)),
                "bound_ms": bound, "bound_by": by,
            }
            fused_ms = _time_ms(lambda: F.rms_norm(x, (D,), w_x, 1e-5))
            log(f"llm-kernels: rmsnorm at {name} {shape}: kernel {timing['ms']:.4f} ms, "
                f"plain {timing['plain_ms']:.4f} ms, F.rms_norm {timing['library_ms']:.4f} ms "
                f"(fp32 weight; {fused_ms:.4f} ms with the weight in x's dtype), "
                f"bound {bound:.4f} ms ({by}); kernel at {nbytes / timing['ms'] / 1e9:.2f} TB/s")
            if name == "prefill rows":
                rms_timing = timing
        del x, got, want
    out["rmsnorm"] = dict(rms_timing, max_abs_err=max_err)

    max_err = 0.0
    for name, shape, dt, with_init in SSD_CASES:
        B, L, H, P, G, N, chunk = (shape[k] for k in ("B", "L", "H", "P", "G", "N", "chunk"))
        dtype = _dtype(dt)
        x = _randn(gen, (B, L, H, P), dtype, 0.5)
        dts = F.softplus(_randn(gen, (B, L, H), torch.float32))
        A = -torch.exp(_randn(gen, (H,), torch.float32, 0.3))
        Bm = _randn(gen, (B, L, G, N), dtype, 0.3)
        Cm = _randn(gen, (B, L, G, N), dtype, 0.3)
        init = _randn(gen, (B, H, P, N), torch.float32) if with_init else None
        y, st = _one_instance(SS.ssd_scan, dtype, lambda: SS.ssd_scan(
            x, dts, A, Bm, Cm, chunk=chunk, initial_state=init))
        want_y, want_st = ref.ssd_reference(x, dts, A, Bm, Cm, chunk=chunk, initial_state=init)
        torch.cuda.synchronize()
        tol, st_tol = _ssd_tols(dtype, chunk)
        err = float((y.float() - want_y.float()).abs().max())
        st_err = float((st - want_st).abs().max())
        max_err = max(max_err, err, st_err)
        if not torch.allclose(y.float(), want_y.float(), atol=tol, rtol=tol):
            fail(f"ssd_scan {name}: kernel y differs from the plain version (max abs {err:.3e}, "
                 f"tolerance {tol})")
        if not torch.allclose(st, want_st, atol=st_tol, rtol=st_tol):
            fail(f"ssd_scan {name}: kernel final state differs from the plain version "
                 f"(max abs {st_err:.3e}, tolerance {st_tol})")
        mirror = ""
        if dt == "bf16":
            my, mst = ref.ssd_chunked_reference(x, dts, A, Bm, Cm, chunk=chunk, initial_state=init)
            gap, beyond, ok = _mirror_gap(y, my)
            st_gap = float((st - mst).abs().max())
            if not ok or not torch.allclose(st, mst, atol=MIRROR_STATE_TOL, rtol=MIRROR_STATE_TOL):
                fail(f"ssd_scan {name}: the tensor-core kernel parts from its mirror: {beyond} "
                     f"elements of y beyond two bf16 ulps + {MIRROR_ATOL} (max abs {gap:.3e}), "
                     f"state {st_gap:.3e} (tolerance {MIRROR_STATE_TOL})")
            mirror = (f"; against its mirror y {gap:.3e} ({beyond} elements beyond two ulps + "
                      f"{MIRROR_ATOL}), state {st_gap:.3e}")
            del my, mst
        log(f"llm-kernels: ssd_scan {name} {dt} {shape} init={with_init}: max abs err y {err:.3e} "
            f"(tol {tol}), state {st_err:.3e} (tol {st_tol}){mirror}")
        if name == "prefill":
            nbytes = sum(t.numel() * t.element_size() for t in (x, dts, A, Bm, Cm, y, st))
            bound, by, flops = _ssd_bound_ms(x, Bm, chunk, nbytes)
            ssd_timing = {
                "ms": _time_ms(lambda: SS.ssd_scan(x, dts, A, Bm, Cm, chunk=chunk)),
                "plain_ms": _time_ms(lambda: ref.ssd_reference(x, dts, A, Bm, Cm, chunk=chunk), reps=5),
                "library_ms": None,  # no single PyTorch call computes the SSD scan
                "bound_ms": bound, "bound_by": by,
            }
            log(f"llm-kernels: ssd_scan at the prefill shape: kernel {ssd_timing['ms']:.4f} ms, "
                f"plain {ssd_timing['plain_ms']:.4f} ms, no library call, bound {bound:.4f} ms "
                f"({by}; {nbytes} bytes, {flops:.4e} FLOPs at least); kernel at "
                f"{flops / ssd_timing['ms'] / 1e9:.2f} TFLOP/s of the least work")
        del x, dts, A, Bm, Cm, init, y, st, want_y, want_st
    out["ssd_scan"] = dict(ssd_timing, max_abs_err=max_err)
    return out


# -- 9-10. serving, the pieces both serve phases use --------------------------


def _sync_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


class _recording:
    """Record the input of every block of ``lm_forward`` and the last
    block's output: ``xs[l]`` enters layer l, ``xs[-1]`` leaves the last."""

    def __init__(self):
        from repro_torch.models import transformer as T

        self.T, self.xs = T, []

    def __enter__(self):
        orig = self.orig = self.T._block_fwd

        def rec(lp, x, *a):
            self.xs.append(x)
            self.out = orig(lp, x, *a)
            return self.out

        self.T._block_fwd = rec
        return self

    def __exit__(self, *exc):
        self.T._block_fwd = self.orig
        self.xs.append(self.out)


def _plain_blocks(q_block: int):
    """Context in which the plain path's flash attention uses ``q_block`` =
    ``kv_block`` (the reference's default is 512): the same function summed
    in another order."""
    import contextlib

    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        saved = dict(ops.flash_attention.__kwdefaults__)
        ops.flash_attention.__kwdefaults__.update(q_block=q_block, kv_block=q_block)
        try:
            yield
        finally:
            ops.flash_attention.__kwdefaults__.update(saved)

    return ctx()


def _compare(a, b, tol):
    """(max abs diff, worst diff / (tol + tol*|b|), argmax agreements) over
    the leading axis, in fp32, one slice at a time."""
    worst, ratio, agree = 0.0, 0.0, 0
    for i in range(a.shape[0]):
        x, y = a[i].float(), b[i].float()
        d = (x - y).abs()
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (tol + tol * y.abs())).max()))
        agree += int((x.argmax(-1) == y.argmax(-1)).sum())
    return worst, ratio, agree


def _layer_divergence(xa, xp):
    """Largest |xa - xp| over largest |xp| for each recorded layer."""
    return [float((a.float() - b.float()).abs().max() / b.float().abs().max()) for a, b in zip(xa, xp)]


class _kernels_on_plain_inputs:
    """While the plain path runs, hand every flash attention, RMSNorm and
    SSD input it computes to the kernel as well, and keep the worst distance
    of the kernel's result from the plain one, in units of the kernel's
    tolerance (flash attention 2e-2 bf16 / 2e-6 fp32, atol = rtol; RMSNorm
    one bf16 unit in the last place / 1e-6; SSD ``_ssd_tols``): the kernels
    held to their plain versions on the main path's own tensors, layer by
    layer."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        _, RMS, FA, SS = _kernel_modules()
        self.ops, self.fa, self.rms, self.ssd = ops, ops.flash_attention, ops.rmsnorm, ops.ssd
        self.worst = {"flash_attention": 0.0, "rmsnorm": 0.0, "ssd_scan": 0.0}
        self.calls = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}

        def fa(q, k, v, **kw):
            out = self.fa(q, k, v, **kw)
            masks = {n: kw[n] for n in ("causal", "window", "chunk", "q_offset") if n in kw}
            tol = 2e-6 if q.dtype == torch.float32 else 2e-2
            d = (FA.flash_attention(q, k, v, **masks).float() - out.float()).abs()
            self._note("flash_attention", float((d / (tol + tol * out.float().abs())).max()))
            return out

        def rms(x, w, eps=1e-5, *, impl="auto"):
            out = self.rms(x, w, eps, impl=impl)
            d = (RMS.rmsnorm(x, w, eps).float() - out.float()).abs()
            y = out.float().abs()
            unit = (torch.exp2(torch.floor(torch.log2(y.clamp_min(1e-30))) - 7)
                    if x.dtype == torch.bfloat16 else 1e-6 + 1e-6 * y)
            self._note("rmsnorm", float((d / unit).max()))
            return out

        def ssd(x, dt, A, Bm, Cm, *, chunk=256, initial_state=None, impl="auto"):
            out, st = self.ssd(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state, impl=impl)
            ky, kst = SS.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
            tol, st_tol = _ssd_tols(x.dtype, chunk)
            ratio = max(float(((ky.float() - out.float()).abs() / (tol + tol * out.float().abs())).max()),
                        float(((kst - st).abs() / (st_tol + st_tol * st.abs())).max()))
            self._note("ssd_scan", ratio)
            return out, st

        ops.flash_attention, ops.rmsnorm, ops.ssd = fa, rms, ssd
        return self

    def _note(self, name, ratio):
        self.worst[name] = max(self.worst[name], ratio)
        self.calls[name] += 1

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.rmsnorm, self.ops.ssd = self.fa, self.rms, self.ssd


def _decode_against_forward(model, params, tokens, logits, n: int = 64):
    """Max abs difference of ``n`` decode steps' logits from the forward's
    logits at the same positions."""
    from repro_torch.serve import init_caches

    caches = init_caches(model, tokens.shape[0], n)
    worst = 0.0
    for t in range(n):
        lg, caches = model.decode_step(params, caches, tokens[:, t], t)
        worst = max(worst, float((lg - logits[:, t].float()).abs().max()))
    return worst


# device-time kinds of the serving paths, by kernel-name substring
SERVE_KINDS = (
    ("flash_attention", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
    ("ssd_scan", ("ssd_scan_kernel", "ssd_tc_")),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "wgmma", "sm90_")),
    ("copy_cast", ("copy", "memcpy", "memset")),
)


def _device_profile(run, kinds=SERVE_KINDS, top: int = 6):
    """One profiled run: its wall time, device time by kind (the first
    kind whose substring is in the kernel's name, else "other"), the idle
    share of the window, and the ``top`` kernels by device time.  None
    where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind = {name: 0.0 for name, _ in kinds}
    by_kind["other"] = 0.0
    names = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.device_time_total:
            continue
        sec = ev.device_time_total / 1e6
        names.append((sec, ev.key))
        low = ev.key.lower()
        kind = next((name for name, subs in kinds if any(x in low for x in subs)), "other")
        by_kind[kind] += sec
    busy = sum(by_kind.values())
    if not busy:
        return None
    return {"wall_s": wall, "busy_s": busy, "idle_share": max(0.0, 1.0 - busy / wall),
            "by_kind": by_kind, "top": sorted(names, reverse=True)[:top]}


def _log_profile(tag, what, prof):
    if prof is None:
        log(f"{tag}: {what}: device time not measured (the profiler saw no device activity)")
        return
    kinds = ", ".join(f"{k} {v * 1e3:.2f}" for k, v in prof["by_kind"].items())
    top = "; ".join(f"{name[:60]} {sec * 1e3:.2f}" for sec, name in prof["top"])
    log(f"{tag}: {what}: wall {prof['wall_s'] * 1e3:.2f} ms, device busy {prof['busy_s'] * 1e3:.2f} ms "
        f"(idle share {prof['idle_share']:.4f}); device ms by kind: {kinds}; top kernels (ms): {top}")


def _serve(tag, cfg, seed, mixer, control, control_what):
    """Serve ``cfg`` at full width and depth with weights drawn from
    ``seed``: ``forward_step`` on 2 prompts of 4096 tokens through the
    kernels (``mixer``, the mixer's kernel, once a layer; RMSNorm on every
    norm), ``greedy_generate`` and decode timings, profiles, then the gates:
    the kernels on the plain path's inputs, the logits against the plain
    path beside ``control()`` (a context and a plain model that compute the
    same function summed in another order), and decode against forward.
    Every tensor of the run is freed when it returns."""
    import gc

    import torch

    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import greedy_generate, init_caches

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{tag}: device memory in use at the start {torch.cuda.memory_allocated()} bytes")
    model = build_model(cfg)  # attn_impl="auto": the kernels on the card
    plain = build_model(cfg, attn_impl="reference")
    # RMSNorms: one per attention mixer, two per mamba mixer (ln, gn), one per
    # MLP, and the final one
    n_norms = cfg.n_layers * ({"flash_attention": 1, "ssd_scan": 2}[mixer] + (cfg.d_ff > 0)) + 1
    expect = {"relational": 0, "flash_attention": 0, "ssd_scan": 0, mixer: cfg.n_layers,
              "rmsnorm": n_norms}
    params, t_init = _sync_s(lambda: model.init(seed, device="cuda"))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{tag}: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, {n_params} parameters "
        f"(fp32, {n_params * 4 / 1e9:.1f} GB) drawn from seed {seed} in {t_init:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    batch = {"tokens": torch.randint(2, cfg.vocab, (2, 4097), generator=gen, device="cuda")}

    _reset_counts()
    logits, t_fwd = _sync_s(lambda: model.forward_step(params, batch))
    fwd_counts = _counts()
    if fwd_counts != expect:
        fail(f"{tag}: forward_step launched {fwd_counts}, expected {expect}")
    # every flash attention and SSD launch of the bf16 forward on the tensor cores
    fwd_inst = _instance_counts()
    if fwd_inst != {k: {"tc": expect[k], "fp32": 0} for k in fwd_inst}:
        fail(f"{tag}: forward_step's launches by instance {fwd_inst}: not all on the tensor-core "
             f"instance")
    if tuple(logits.shape) != (2, 4096, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"{tag}: forward logits of shape {tuple(logits.shape)} or not finite")
    _, t_fwd2 = _sync_s(lambda: model.forward_step(params, batch))
    log(f"{tag}: forward_step on 2 x 4096 tokens: {t_fwd:.3f} s (first call), {t_fwd2:.3f} s "
        f"(second); launches {fwd_counts}, by instance {fwd_inst}")

    prompts = torch.randint(2, cfg.vocab, (4, 128), generator=gen, device="cuda")
    greedy_generate(model, params, prompts[:, :8], max_new_tokens=2)  # first-use costs at B=4
    _reset_counts()
    # each timed twice, the faster kept: host time between calls varies
    first, t_prefill = _sync_s(lambda: greedy_generate(model, params, prompts, max_new_tokens=1))
    toks, t_full = _sync_s(lambda: greedy_generate(model, params, prompts, max_new_tokens=32))
    t_prefill = min(t_prefill, _sync_s(lambda: greedy_generate(model, params, prompts, max_new_tokens=1))[1])
    t_full = min(t_full, _sync_s(lambda: greedy_generate(model, params, prompts, max_new_tokens=32))[1])
    gen_counts = _counts()
    steps = 2 * (128 + (128 + 31))
    if gen_counts != dict({k: 0 for k in expect}, rmsnorm=steps * n_norms):
        fail(f"{tag}: greedy_generate launched {gen_counts} over {steps} decode steps")
    if tuple(toks.shape) != (4, 32) or not torch.equal(toks[:, :1], first):
        fail(f"{tag}: greedy_generate's tokens have the wrong shape or first token")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        fail(f"{tag}: greedy_generate produced a token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()

    # decode alone: 31 greedy steps of 4 after the 128-token prompt, as in
    # greedy_generate's decode phase, timed without the prefill
    caches = init_caches(model, 4, 160)
    for t in range(128):
        logits_t, caches = model.decode_step(params, caches, prompts[:, t], t)
    state = {k: v.clone() for k, v in tree_leaves(caches)}  # SSM caches move on every step

    def decode_from(t0, n):
        for k, v in tree_leaves(caches):
            v.copy_(state[k])
        tok = logits_t.argmax(-1)
        for t in range(t0, t0 + n):
            lg, _ = model.decode_step(params, caches, tok, t)
            tok = lg.argmax(-1)

    t_dec = min(_sync_s(lambda: decode_from(128, 31))[1], _sync_s(lambda: decode_from(128, 31))[1])
    decode_tps = 4 * 31 / t_dec
    log(f"{tag}: greedy_generate 4 x 128 prompt tokens: prefill (token by token) {t_prefill:.3f} s; "
        f"with 32 new tokens {t_full:.3f} s; launches {gen_counts}")
    log(f"{tag}: decode alone, 31 steps of 4 after the prompt: {t_dec:.3f} s, {decode_tps:.1f} "
        f"tokens/s ({t_dec / 31 * 1e3:.2f} ms a step)")
    log(f"{tag}: device memory high-water mark of serving (weights, forward_step, "
        f"greedy_generate) {peak / 2**30:.2f} GiB ({peak} bytes)")

    # where the time goes: one profiled forward_step, and 8 profiled decode steps at B=4
    _log_profile(tag, "profiled forward_step",
                 _device_profile(lambda: model.forward_step(params, batch)))
    _log_profile(tag, "8 profiled decode steps (B=4, cache of 160)",
                 _device_profile(lambda: decode_from(128, 8)))
    del caches, state

    # the plain path, free running, with every kernel also run on its inputs
    with _recording() as rec_p, _kernels_on_plain_inputs() as held:
        logits_plain, t_plain = _sync_s(lambda: plain.forward_step(params, batch))
    with _recording() as rec_a:
        model.forward_step(params, batch)
    # the control: the plain path summed in another order
    ctx, ctrl_model = control()
    _reset_counts()
    with ctx, _recording() as rec_c:
        logits_ctrl = ctrl_model.forward_step(params, batch)
    if any(_counts().values()):
        fail(f"{tag}: the plain path launched a kernel: {_counts()}")
    diff, ratio, agree = _compare(logits, logits_plain, LOGIT_TOL)
    c_diff, c_ratio, c_agree = _compare(logits_ctrl, logits_plain, LOGIT_TOL)
    div_a = _layer_divergence(rec_a.xs, rec_p.xs)
    div_c = _layer_divergence(rec_c.xs, rec_p.xs)
    del logits_ctrl, rec_a, rec_p, rec_c
    held_calls = {k: v for k, v in held.calls.items() if v}
    log(f"{tag}: plain forward {t_plain:.3f} s (with the kernels run beside it); every layer's "
        f"kernel inputs through the kernels: worst distance in tolerances "
        + ", ".join(f"{k} {held.worst[k]:.3f} over {n} calls" for k, n in held_calls.items()))
    log(f"{tag}: logits, kernels against plain, free running: max abs diff {diff:.4e} "
        f"({ratio:.2f} x tol {LOGIT_TOL}), argmax equal at {agree} of {2 * 4096}; control "
        f"({control_what}): {c_diff:.4e} ({c_ratio:.2f} x tol), argmax equal at {c_agree}")
    log(f"{tag}: residual-stream divergence, max |difference| / max |plain| after layers "
        + ", ".join(f"{l}: {div_a[l]:.3e} (control {div_c[l]:.3e})"
                    for l in sorted({1, 2, 4, 8, 16, 24, 32, 48, len(div_a) - 1} & set(range(len(div_a))))))
    if held_calls != {k: v for k, v in expect.items() if v}:
        fail(f"{tag}: the plain path ran {held.calls} kernel inputs, expected {expect}")
    for name, worst in held.worst.items():
        if worst > 1.0:
            fail(f"{tag}: {name} on the main path's inputs is {worst:.3f} tolerances from plain")
    if diff > CONTROL_FACTOR * c_diff or (2 * 4096 - agree) > CONTROL_FACTOR * (2 * 4096 - c_agree):
        fail(f"{tag}: the kernels' logits part from the plain path by more than {CONTROL_FACTOR} x "
             f"the plain path's own reordering does (max abs {diff:.4e} vs {c_diff:.4e}, "
             f"argmax {agree} vs {c_agree})")

    dec = _decode_against_forward(model, params, batch["tokens"], logits)
    dec_plain = _decode_against_forward(plain, params, batch["tokens"], logits_plain)
    log(f"{tag}: decode steps 0..63 against the forward's logits: max abs diff {dec:.4e} on the "
        f"kernel path, {dec_plain:.4e} on the plain path")
    if dec > CONTROL_FACTOR * dec_plain:
        fail(f"{tag}: decode against forward parts by {dec:.4e} on the kernel path, more than "
             f"{CONTROL_FACTOR} x the plain path's {dec_plain:.4e}")
    del logits_plain
    log(f"{tag}: device memory high-water mark with the checks' recordings "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {k: fwd_counts[k] + gen_counts[k] for k in fwd_counts}
    # greedy_generate launches neither (its decode steps run the plain mixers)
    return {"launches": launches, "instances": fwd_inst, "t_forward": t_fwd2,
            "t_prefill": t_prefill, "decode_tps": decode_tps, "peak_bytes": peak}


# -- 9. serve llama3-8b ------------------------------------------------------------


def phase_serve(seed: int):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("llama3-8b")
    # control: attention blocks of 256 instead of the plain path's 512
    return _serve("serve", cfg, seed, "flash_attention",
                  lambda: (_plain_blocks(256), build_model(cfg, attn_impl="reference")),
                  "the plain path with attention blocks of 256 against 512")


# -- 10. serve mamba2-2.7b ---------------------------------------------------------


def phase_serve_mamba(seed: int):
    import contextlib
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("mamba2-2.7b")
    # control: SSD in chunks of 128 instead of 256, the same function
    ctrl = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=128))
    return _serve("serve-mamba", cfg, seed, "ssd_scan",
                  lambda: (contextlib.nullcontext(), build_model(ctrl, attn_impl="reference")),
                  "the plain path with SSD chunks of 128 against 256")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the serving phase's weights and tokens")
    args = ap.parse_args()
    card = phase_device()
    import torch

    build = phase_build()
    max_err, _ = phase_kernel()
    main = phase_main_path()
    phase_reuse()
    phase_verify(card)
    phase_verify_corpus(card)
    chain = phase_chain(card)
    service = phase_service(card, chain.pop("served"))
    # the fleet's forkserver and resource tracker would otherwise outlive it
    # until this process exits: the script leaves nothing running behind it
    from repro_torch.service import stop_helper_processes

    stop_helper_processes()
    llm = phase_llm_kernels(args.seed)
    serve = phase_serve(args.seed)
    mamba = phase_serve_mamba(args.seed)
    shape = main["main_shape"]
    kernels = [{
        "name": "relational",
        "route": "cuda",
        "source": "src/repro_torch/csrc/relational.cu",
        "replaces": "src/repro/kernels/relational.py:111",
        # the hot chain's launches plus the chain phase's (its delta masks among
        # them) and the service's threads'; the fleet workers' own are logged
        "launches": main["launches"] + chain["launches"] + service["launches"],
        "max_abs_err": max_err,
        "ms": shape["ms"],
        "plain_ms": shape["plain_ms"],
        "bound_ms": shape["bound_ms"],
        "bound_by": shape["bound_by"],
        # no one PyTorch call rounds each multiply and add on its own in this order
        "library_ms": None,
        "kernel_only_ms": shape["kernel_ms"],
        "call_ms": shape["call_ms"],
        # one instance per plan route; launches on the hot chain's run
        "instances": [{"instance": route, "launches": count}
                      for route, count in main["instances"].items()],
    }]
    # launches: the sum over the serving paths, each counted from 0 around its own run
    # flash attention and the SSD scan have two instances: the main path's bf16
    # one on the tensor cores (its source is the entry's), and the fp32 one
    for name, replaces in (("rmsnorm", "src/repro/kernels/rmsnorm.py:20"),
                           ("flash_attention", "src/repro/kernels/flash_attention.py:112"),
                           ("ssd_scan", "src/repro/kernels/ssd_scan.py:89")):
        k = llm[name]
        two = name in ("flash_attention", "ssd_scan")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}{'_sm90' if two else ''}.cu",
            "replaces": replaces,
            "launches": serve["launches"][name] + mamba["launches"][name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
        if two:
            kernels[-1]["instances"] = [
                {"instance": inst, "dtype": dt, "source": f"src/repro_torch/csrc/{name}{suffix}.cu",
                 "launches": serve["instances"][name][inst] + mamba["instances"][name][inst]}
                for inst, dt, suffix in (("tc", "bf16", "_sm90"), ("fp32", "fp32", ""))]
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']}: never launched on its main path")
    log(f"build seconds: {build['seconds']:.2f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
