"""The SSD backward's tensor-core instance (``csrc/ssd_scan_bwd_sm90.cu``)
on the card: against its plain mirror (``ref.ssd_bwd_tc_reference``) on
the same bf16 inputs, and which instance each call launches.  Its
comparison with the plain backward (``ref.ssd_bwd_reference``) is
``tests/test_torch_ssd_bwd_cuda.py``'s, whose bf16 model shapes take this
instance.

This file imports neither JAX nor the reference package, so its ``cuda``
tests run on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_bwd_tc_cuda.py

Tolerances are ``tests/test_torch_ssd_bwd_cuda.py``'s (``_check``,
``_exact_dA``): a bf16 gradient (dx, dB, dC) every element within two bf16
units in the last place plus 1e-3 of the largest element; an fp32 one
(d_dt, the initial state's) within 1e-5 of its largest element; dA against
the plain backward on the inputs cast up to float64, within the larger of
1e-5 of its largest element and twice the fp32 plain version's distance
from it.
"""

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SS
from test_torch_ssd_bwd_cuda import NAMES, _check, _cuda, _exact_dA, _inputs

# (name, B, L, H, P, G, N, chunk, initial state, gradient of the final state)
CASES = (
    ("mamba2-2.7b prefill", 2, 4096, 80, 64, 1, 128, 256, False, False),
    ("jamba heads, final state's gradient", 1, 512, 256, 64, 1, 128, 256, False, True),
    ("G=2, N 64, chunk 64, states in and out", 2, 256, 12, 64, 2, 64, 64, True, True),
    ("chunk 128, initial state", 1, 512, 16, 64, 1, 128, 128, True, False),
)
COUNTS = ("launches", "launches_bf16", "launches_fp32", "launches_tc")


def _counts():
    return {k: getattr(SS.ssd_scan_bwd, k) for k in COUNTS}


def _launched(args, kw):
    before = _counts()
    got = SS.ssd_scan_bwd(*args, **kw)
    torch.cuda.synchronize()
    return got, {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_backward_matches_mirror(case):
    _cuda()
    args, kw = _inputs(case, torch.bfloat16, "cuda")
    got, moved = _launched(args, kw)
    assert moved == {"launches": 1, "launches_bf16": 1, "launches_fp32": 0, "launches_tc": 1}
    want = ref.ssd_bwd_tc_reference(*args, **kw)
    exact = _exact_dA(args, kw)
    plain_dA = ref.ssd_bwd_reference(*args, **kw)[2]
    for name, g, w in zip(NAMES, got, want):
        if name == "dA":
            _check(g, exact.float(), f"{case[0]} dA", 2 * float((plain_dA.double() - exact).abs().max()))
        else:
            _check(g, w, f"{case[0]} against the mirror: {name}")


@pytest.mark.cuda
def test_tc_backward_is_deterministic():
    _cuda()
    args, kw = _inputs(CASES[2], torch.bfloat16, "cuda")
    first = SS.ssd_scan_bwd(*args, **kw)
    second = SS.ssd_scan_bwd(*args, **kw)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, case", [
    (torch.float32, CASES[0]),
    (torch.bfloat16, ("P 24, N 40, chunk 32", 1, 96, 3, 24, 1, 40, 32, True, True)),
], ids=["fp32 at the mamba2 shape", "bf16 outside the shape rule"])
def test_launches_tc_does_not_move_off_the_tensor_cores(dtype, case):
    """fp32, and bf16 at a shape outside ``bwd_on_tensor_cores``, run the
    CUDA-core instance: ``.launches_tc`` does not move."""
    _cuda()
    args, kw = _inputs(case, dtype, "cuda")
    _, moved = _launched(args, kw)
    bf16 = int(dtype == torch.bfloat16)
    assert moved == {"launches": 1, "launches_bf16": bf16, "launches_fp32": 1 - bf16, "launches_tc": 0}


@pytest.mark.cuda
def test_head_runs_agree_with_the_mirror():
    _cuda()
    lib = SS._library_bwd_tc()
    for rep in (1, 2, 3, 7, 8, 12, 80, 256):
        assert lib.veer_ssd_scan_bwd_tc_head_run(rep) == ref.ssd_bwd_head_run(rep), rep
