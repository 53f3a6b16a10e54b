"""The SSD scan's backward: its autograd Function and dispatch on the host,
and the hand-written kernel (``csrc/ssd_scan_bwd.cu``) against its plain
version (``ref.ssd_bwd_reference``) on the card.

This file imports neither JAX nor the reference package, so its ``cuda``
tests run on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_bwd_cuda.py

Tolerances on the card (the plain backward's gradients on the same inputs):
fp32 gradients within 1e-5 of the largest element (the kernel sums in
another order); dA against the plain backward in float64 within that or
twice the fp32 plain version's own distance from it, whichever is larger
(``_exact_dA``: an ordered sum of B L terms that cancel); bf16 ones (dx,
dB, dC of bf16 inputs) every element within two bf16 units in the last
place of the plain value plus 1e-3 of the largest element (the fp32 sums
round to bf16 once, so a rounding may fall the other way), as
``tests/test_torch_bwd_cuda.py`` holds the other backward kernels.  The kernel twice on the same inputs: the same bits.
Reduced models' gradients through the kernels within 2e-2 relative L2 a
leaf of the plain path's: mamba2 in bf16 compute (its SSD widened to head
64, state 64, chunk 64, shapes the bf16 forward kernel takes), jamba in
fp32 compute (its bf16 routing is near-tied, ROADMAP queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models.transformer as PT
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import build_model
from repro_torch.models.layers import tree_from_leaves, tree_leaves

NAMES = ("dx", "d_dt", "dA", "dBm", "dCm", "d_initial_state")

# (name, B, L, H, P, G, N, chunk, initial state, gradient of the final state)
CASES = (
    ("mamba2-2.7b prefill", 2, 4096, 80, 64, 1, 128, 256, False, False),
    ("ragged: P 24, N 40, chunk 32", 1, 96, 3, 24, 1, 40, 32, True, True),
    ("two P tiles, chunk 80, G=2", 2, 160, 4, 80, 2, 16, 80, True, False),
    ("jamba heads, single chunk", 1, 256, 256, 64, 1, 128, 256, False, True),
)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")


def _inputs(case, dtype, device):
    """x, dt, A, Bm, Cm, dy in ``dtype`` (dt, A fp32) and the states or None."""
    _, B, L, H, P, G, N, chunk, init, dfin = case
    rng = np.random.default_rng(L + H)

    def t(shape, scale=1.0, d=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(device, d)

    x, dy = t((B, L, H, P), 0.5, dtype), t((B, L, H, P), 0.5, dtype)
    dt = torch.nn.functional.softplus(t((B, L, H)))
    A = -torch.exp(t((H,), 0.3))
    Bm, Cm = t((B, L, G, N), 0.3, dtype), t((B, L, G, N), 0.3, dtype)
    return (x, dt, A, Bm, Cm, dy), dict(chunk=chunk, initial_state=t((B, H, P, N)) if init else None,
                                       d_final_state=t((B, H, P, N)) if dfin else None)


def _check(got, want, name, floor=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) or 1.0
    d = (g - w).abs()
    if got.dtype == torch.float32:
        assert float(d.max()) <= max(1e-5 * scale, floor), f"{name}: {float(d.max()):.3e} of {scale:.3e}"
    else:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool((d <= 2 * ulp + 1e-3 * scale).all()), f"{name}: {float(d.max()):.3e} of {scale:.3e}"


# -- on the host -----------------------------------------------------------------


def test_the_wrapper_under_grad_runs_the_function_with_the_plain_backward_on_the_host():
    (x, dt, A, Bm, Cm, dy), kw = _inputs(CASES[2], torch.float32, "cpu")
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, kw["initial_state"])]
    before = (SS.ssd_scan.launches, SS.ssd_scan_bwd.launches)
    y, state = SS.ssd_scan(*leaves[:5], chunk=kw["chunk"], initial_state=leaves[5])
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad(y, leaves, dy)
    want = ref.ssd_bwd_reference(x, dt, A, Bm, Cm, dy, chunk=kw["chunk"], initial_state=kw["initial_state"])
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert (SS.ssd_scan.launches, SS.ssd_scan_bwd.launches) == before
    with torch.no_grad():
        y2, _ = SS.ssd_scan(*leaves[:5], chunk=kw["chunk"], initial_state=leaves[5])
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_impl_reference_differentiates_the_plain_forward():
    """``impl="reference"`` stays autograd through ``ref.ssd_reference``:
    the plain path the card holds the kernels to."""
    (x, dt, A, Bm, Cm, dy), kw = _inputs(CASES[1], torch.float32, "cpu")
    xr = x.clone().requires_grad_()
    y, _ = ops.ssd(xr, dt, A, Bm, Cm, chunk=kw["chunk"], impl="reference")
    assert y.grad_fn is not None and type(y.grad_fn).__name__ != "SSDScanBackward"
    (gx,) = torch.autograd.grad(y, xr, dy)
    want = ref.ssd_bwd_reference(x, dt, A, Bm, Cm, dy, chunk=kw["chunk"])[0]
    assert float((gx - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_backward_refuses_mixed_devices():
    (x, dt, A, Bm, Cm, dy), kw = _inputs(CASES[1], torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.to("meta"), chunk=kw["chunk"])
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=kw["chunk"], d_final_state=torch.ones(1, device="meta"))


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ssd_backward_kernel_matches_plain(case, dt):
    _cuda()
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
    args, kw = _inputs(case, dtype, "cuda")
    before = (SS.ssd_scan_bwd.launches, SS.ssd_scan_bwd.launches_bf16, SS.ssd_scan_bwd.launches_fp32)
    got = SS.ssd_scan_bwd(*args, **kw)
    want = ref.ssd_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert (SS.ssd_scan_bwd.launches, SS.ssd_scan_bwd.launches_bf16, SS.ssd_scan_bwd.launches_fp32) == (
        before[0] + 1, before[1] + bf16, before[2] + 1 - bf16)
    exact = _exact_dA(args, kw)
    for name, g, w in zip(NAMES, got, want):
        floor = 0.0
        if name == "dA":
            w, floor = exact.float(), 2 * float((w.double() - exact).abs().max())
        _check(g, w, f"{case[0]} {dt} {name}", floor)


def _exact_dA(args, kw):
    """dA of the plain backward on the same inputs cast up to float64:
    ``dA A = Σ_k cs_k dcs_k`` over B L terms with |cs| up to ~100 cancels,
    so the fp32 plain version parts from it by more than 1e-5 of the
    largest element at the main path's shapes."""
    up = [t.double() if torch.is_tensor(t) else t for t in args]
    return ref.ssd_bwd_reference(*up, **{k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()})[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_ssd_backward_kernel_is_deterministic(dt):
    _cuda()
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
    args, kw = _inputs(CASES[2], dtype, "cuda")
    first = SS.ssd_scan_bwd(*args, **kw)
    second = SS.ssd_scan_bwd(*args, **kw)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_ssd_backward_refuses_shapes_it_cannot_take():
    _cuda()
    (x, dt, A, Bm, Cm, dy), kw = _inputs(CASES[1], torch.float32, "cuda")
    wide = torch.zeros(Bm.shape[:3] + (256,), device="cuda")
    with pytest.raises(ValueError, match="N up to 128"):
        SS.ssd_scan_bwd(x, dt, A, wide, wide, dy, chunk=kw["chunk"])
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        SS.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=40)
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.cpu(), chunk=kw["chunk"])


@pytest.mark.cuda
def test_the_function_on_the_card_launches_the_backward_kernel():
    _cuda()
    # a shape the bf16 forward (the tensor-core instance) takes: P 64, N 64, chunk 64
    case = ("bf16 forward's shape", 2, 256, 8, 64, 2, 64, 64, True, False)
    (x, dt, A, Bm, Cm, dy), kw = _inputs(case, torch.bfloat16, "cuda")
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, kw["initial_state"])]
    before = (SS.ssd_scan_bwd.launches, SS.ssd_scan_bwd.launches_bf16)
    y, state = SS.ssd_scan(*leaves[:5], chunk=kw["chunk"], initial_state=leaves[5])
    got = torch.autograd.grad((y, state), leaves, (dy, torch.ones_like(state)))
    assert (SS.ssd_scan_bwd.launches, SS.ssd_scan_bwd.launches_bf16) == (before[0] + 1, before[1] + 1)
    want = ref.ssd_bwd_reference(x, dt, A, Bm, Cm, dy, chunk=kw["chunk"], initial_state=kw["initial_state"],
                                 d_final_state=torch.ones_like(state))
    for name, g, w in zip(NAMES, got, want):
        _check(g, w.to(g.dtype), name)


def _grads_against_plain(cfg, params, batch, loss_fn):
    """Each leaf's relative L2 distance between the gradients through the
    kernels and on the plain path, and the SSD backward launches."""
    before = SS.ssd_scan_bwd.launches
    got = loss_fn(build_model(cfg), params, batch)
    launches = SS.ssd_scan_bwd.launches - before
    want = loss_fn(build_model(cfg, attn_impl="reference"), params, batch)
    assert SS.ssd_scan_bwd.launches - before == launches
    assert abs(float(got[0]) - float(want[0])) <= 0.02 + 0.02 * abs(float(want[0]))
    rel = {p: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for (p, a), (_, b) in zip(tree_leaves(got[1]), tree_leaves(want[1]))}
    return rel, launches


@pytest.mark.cuda
def test_mamba_loss_grads_on_the_card_go_through_the_ssd_backward_kernel():
    _cuda()
    from repro_torch.train import loss_and_grads

    base = get_arch("mamba2-2.7b").with_reduced()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm, head_dim=64, d_state=64, chunk=64))
    params = build_model(cfg).init(0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 129))).cuda()
    rel, launches = _grads_against_plain(cfg, params, {"tokens": tokens},
                                         lambda m, p, b: loss_and_grads(m, p, b))
    assert launches == cfg.n_layers
    assert max(rel.values()) <= 2e-2, rel


@pytest.mark.cuda
def test_jamba_fp32_grads_on_the_card_go_through_the_ssd_backward_kernel(monkeypatch):
    _cuda()
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    cfg = get_arch("jamba-1.5-large-398b").with_reduced()
    params = build_model(cfg).init(0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab, (2, 65))).cuda()
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]

    def loss_fn(model, p, b):
        loss = model.loss(p, b)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_from_leaves(zip([q for q, _ in tree_leaves(p)], grads))

    before = SS.ssd_scan_bwd.launches_fp32
    rel, launches = _grads_against_plain(cfg, params, {"tokens": tokens}, loss_fn)
    assert launches == sum(k == "mamba" for k in cfg.pattern[:cfg.n_layers])
    assert SS.ssd_scan_bwd.launches_fp32 - before == launches
    assert max(rel.values()) <= 2e-2, rel
