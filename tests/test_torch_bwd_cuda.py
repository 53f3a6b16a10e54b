"""The backward kernels of flash attention and RMSNorm: their autograd
Functions and dispatch on the host, no graph-less output anywhere, and each
kernel against its plain version on the card.

This file imports neither JAX nor the reference package, so its ``cuda``
tests run on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bwd_cuda.py

Tolerances on the card (the gradients of the plain backward on the same
``(q, k, v, o, lse, dO)`` and ``(x, w, g)``): fp32 within 1e-5 of the
largest gradient element (the kernels sum in another order); bf16 every
element within two bf16 units in the last place of the plain value plus
1e-3 of the largest gradient element (the fp32 sums round to bf16 once, so
a rounding may fall the other way).  The forward with an ``lse`` output:
its output as the serving launch's, bit for bit, and lse within 1e-5 of
the plain forward's.  The bf16 flash backward (the tensor-core instance)
against its mirror ``ref.flash_attention_bwd_tc_reference``: two bf16 units
in the last place of the mirror's value plus 1e-4 of the largest gradient
element (the two sum their fp32 terms in other orders and take exp2 to
within two fp32 ulps, so a rounding may fall the other way, and a value
that cancels to near zero keeps its absolute error).  Each backward kernel
twice on the same inputs: the same bits.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RMS
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves

# (name, B, S, T, H, KV, D, masks): every mask, q_offset, S != T, a ragged T
CASES = (
    ("causal GQA", 2, 256, 256, 8, 2, 64, dict(causal=True)),
    ("window", 1, 300, 300, 4, 4, 64, dict(causal=True, window=70)),
    ("chunk", 1, 256, 256, 4, 2, 32, dict(causal=True, chunk=96)),
    ("q_offset, S < T", 1, 100, 400, 4, 1, 128, dict(causal=True, q_offset=300)),
    ("not causal, T = 128 + 92", 2, 77, 220, 6, 6, 64, dict(causal=False)),
    ("whisper cross, S=448, T=1500", 1, 448, 1500, 6, 6, 64, dict(causal=False)),
    ("prefill head dim", 1, 512, 512, 8, 2, 128, dict(causal=True)),
    ("D=16, tail", 1, 65, 65, 2, 1, 16, dict(causal=True)),
)


def _rand(shape, dtype, seed, device="cpu", scale=0.5):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(device, dtype)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")


def _held(got, want, dtype, floor=1e-3):
    """The card's gradient against the plain one (or, with ``floor`` 1e-4,
    the bf16 kernel's against its mirror): the tolerances above."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) or 1.0
    d = (got - want).abs()
    if dtype == torch.float32:
        return float(d.max()) <= 1e-5 * scale
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool((d <= 2 * ulp + floor * scale).all())


def _flash_inputs(case, dtype):
    """q, k, v, dO on the card, and the forward's o and lse on them."""
    _, B, S, T, H, KV, D, masks = case
    q = _rand((B, S, H, D), dtype, 1, "cuda")
    k = _rand((B, T, KV, D), dtype, 2, "cuda")
    v = _rand((B, T, KV, D), dtype, 3, "cuda")
    g = _rand((B, S, H, D), dtype, 4, "cuda")
    out, lse = FA._launch(q, k, v, masks.get("causal", True), masks.get("window"), masks.get("chunk"),
                          masks.get("q_offset", 0), with_lse=True)
    return q, k, v, out, lse, g


# -- on the host -----------------------------------------------------------------


def test_flash_wrapper_runs_the_plain_backward_on_the_host():
    q, k, v = (_rand(s, torch.float32, i) for i, s in enumerate(((1, 40, 4, 16), (1, 40, 2, 16),
                                                                    (1, 40, 2, 16))))
    g = _rand((1, 40, 4, 16), torch.float32, 9)
    for t in (q, k, v):
        t.requires_grad_()
    out = FA.flash_attention(q, k, v, causal=True, window=13)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad(out, (q, k, v), g)
    o, lse = ref._flash_fwd_impl(q.detach(), k.detach(), v.detach(), True, 13, None, 512, 512, 0)
    want = ref.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o, lse, g,
                                             causal=True, window=13)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(out.detach(), o)


def test_rmsnorm_function_runs_the_plain_backward_on_the_host():
    x = _rand((3, 5, 24), torch.float32, 1, scale=1.0).requires_grad_()
    w = _rand((24,), torch.float32, 2, scale=1.0).requires_grad_()
    g = _rand((3, 5, 24), torch.float32, 3, scale=1.0)
    out = RMS.rmsnorm(x, w, 1e-5)
    assert type(out.grad_fn).__name__.startswith("RMSNorm")
    dx, dw = torch.autograd.grad(out, (x, w), g)
    want_dx, want_dw = ref.rmsnorm_bwd_reference(x.detach(), w.detach(), g, 1e-5)
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_no_grad_and_no_requires_grad_build_no_graph(impl):
    q, k, v = (_rand(s, torch.float32, i) for i, s in enumerate(((1, 8, 2, 16), (1, 8, 2, 16),
                                                                    (1, 8, 2, 16))))
    x, w = _rand((4, 16), torch.float32, 5), torch.ones(16)
    assert ops.flash_attention(q, k, v, impl=impl).grad_fn is None
    assert ops.rmsnorm(x, w, impl=impl).grad_fn is None
    q.requires_grad_()
    w.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, impl=impl).grad_fn is None
        assert ops.rmsnorm(x, w, impl=impl).grad_fn is None
    assert ops.flash_attention(q, k, v, impl=impl).grad_fn is not None
    assert ops.rmsnorm(x, w, impl=impl).grad_fn is not None


def test_forward_step_builds_no_graph_and_loss_does():
    """Serving entry points stay under no_grad; the loss is differentiable."""
    cfg = get_arch("llama3-8b").with_reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    for _, t in tree_leaves(params):
        t.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 17)))
    batch = {"tokens": tokens}
    assert not model.forward_step(params, batch).requires_grad
    assert not model.forward(params, tokens[:, :-1]).requires_grad
    assert model.loss(params, batch).requires_grad
    with torch.no_grad():
        assert not model.loss(params, batch).requires_grad


def test_backward_wrappers_refuse_mixed_devices():
    q = torch.ones(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(q, q, q, q, torch.ones(1, 4, 2), q.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        RMS.rmsnorm_bwd(torch.ones(2, 8), torch.ones(8), torch.ones(2, 8, device="meta"))


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_backward_kernel_matches_plain(case, dt):
    _cuda()
    name, B, S, T, H, KV, D, masks = case
    dtype = torch.float32 if dt == "fp32" else torch.bfloat16
    q = _rand((B, S, H, D), dtype, 1, "cuda")
    k = _rand((B, T, KV, D), dtype, 2, "cuda")
    v = _rand((B, T, KV, D), dtype, 3, "cuda")
    g = _rand((B, S, H, D), dtype, 4, "cuda")
    out, lse = FA._launch(q, k, v, masks.get("causal", True), masks.get("window"), masks.get("chunk"),
                          masks.get("q_offset", 0), with_lse=True)
    serve, none = FA._launch(q, k, v, masks.get("causal", True), masks.get("window"),
                             masks.get("chunk"), masks.get("q_offset", 0))
    assert none is None and torch.equal(out, serve)  # the lse output moves nothing
    _, want_lse = ref._flash_fwd_impl(q, k, v, masks.get("causal", True), masks.get("window"),
                                      masks.get("chunk"), 512, 512, masks.get("q_offset", 0))
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, out, lse, g, **masks)
    assert FA.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_reference(q, k, v, out, lse, g, **masks)
    torch.cuda.synchronize()
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _held(a, b, dtype), f"{name} {dt} {what}: max abs {float((a.float() - b.float()).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 300, 4096), (1000, 4097), (7, 384), (3, 1, 2048)])
def test_rmsnorm_backward_kernel_matches_plain(shape, dt):
    _cuda()
    dtype = torch.float32 if dt == "fp32" else torch.bfloat16
    x = _rand(shape, dtype, 1, "cuda", 1.0)
    w = _rand(shape[-1:], torch.float32, 2, "cuda", 1.0)
    g = _rand(shape, dtype, 3, "cuda", 1.0)
    before = RMS.rmsnorm_bwd.launches
    dx, dw = RMS.rmsnorm_bwd(x, w, g, 1e-5)
    assert RMS.rmsnorm_bwd.launches == before + 1
    want_dx, want_dw = ref.rmsnorm_bwd_reference(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert _held(dx, want_dx, dtype)
    assert _held(dw, want_dw, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((3, 12288), torch.float32), ((3, 20000), torch.float32),
                                         ((2, 24576), torch.bfloat16), ((2, 65536), torch.bfloat16)],
                         ids=["fp32-12288", "fp32-20000", "bf16-24576", "bf16-65536"])
def test_rmsnorm_backward_kernel_takes_rows_wider_than_shared_memory(shape, dtype):
    """Rows past the registers go through shared memory (12288 fp32, 24576
    bf16) and rows past shared memory through device memory (20000 fp32,
    65536 bf16): each within the plain version's tolerance, the same bits on
    a second launch."""
    _cuda()
    x = _rand(shape, dtype, 1, "cuda", 1.0)
    w = _rand(shape[-1:], torch.float32, 2, "cuda", 1.0)
    g = _rand(shape, dtype, 3, "cuda", 1.0)
    (dx, dw), (dx2, dw2) = RMS.rmsnorm_bwd(x, w, g, 1e-5), RMS.rmsnorm_bwd(x, w, g, 1e-5)
    want_dx, want_dw = ref.rmsnorm_bwd_reference(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert _held(dx, want_dx, dtype)
    assert _held(dw, want_dw, torch.float32)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_dense_loss_grads_on_the_card_go_through_the_backward_kernels():
    """A reduced dense model's gradients through the kernels: every flash
    attention and RMSNorm backward launched, each leaf within 2e-2 relative
    L2 of the plain path's."""
    _cuda()
    from repro_torch.train import loss_and_grads

    cfg = get_arch("llama3-8b").with_reduced()
    params = build_model(cfg).init(0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 129))).cuda()
    fa, rms = FA.flash_attention_bwd.launches, RMS.rmsnorm_bwd.launches
    loss, grads = loss_and_grads(build_model(cfg), params, {"tokens": tokens})
    assert FA.flash_attention_bwd.launches - fa == cfg.n_layers
    assert RMS.rmsnorm_bwd.launches - rms == 2 * cfg.n_layers + 1
    want_loss, want = loss_and_grads(build_model(cfg, attn_impl="reference"), params, {"tokens": tokens})
    assert abs(float(loss) - float(want_loss)) <= 0.02 + 0.02 * abs(float(want_loss))
    for (path, a), (_, b) in zip(tree_leaves(grads), tree_leaves(want)):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 2e-2, path


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_backward_tc_kernel_matches_its_mirror(case):
    _cuda()
    name, masks = case[0], case[-1]
    args = _flash_inputs(case, torch.bfloat16)
    before = (FA.flash_attention_bwd.launches_tc, FA.flash_attention_bwd.launches_fp32)
    got = FA.flash_attention_bwd(*args, **masks)
    assert (FA.flash_attention_bwd.launches_tc, FA.flash_attention_bwd.launches_fp32) == (before[0] + 1,
                                                                                          before[1])
    want = ref.flash_attention_bwd_tc_reference(*args, **masks)
    torch.cuda.synchronize()
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _held(a, b, torch.bfloat16, floor=1e-4), \
            f"{name} {what}: max abs {float((a.float() - b.float()).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES[::3], ids=[c[0] for c in CASES[::3]])
def test_flash_backward_kernels_are_deterministic(case, dt):
    _cuda()
    dtype = torch.float32 if dt == "fp32" else torch.bfloat16
    args = _flash_inputs(case, dtype)
    first = FA.flash_attention_bwd(*args, **case[-1])
    again = FA.flash_attention_bwd(*args, **case[-1])
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16 if dt == "bf16" else torch.int32),
                           b.view(torch.int16 if dt == "bf16" else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(8192, 4096), (7, 384)])
def test_rmsnorm_backward_kernel_is_deterministic(shape, dt):
    _cuda()
    dtype = torch.float32 if dt == "fp32" else torch.bfloat16
    x = _rand(shape, dtype, 1, "cuda", 1.0)
    w = _rand(shape[-1:], torch.float32, 2, "cuda", 1.0)
    g = _rand(shape, dtype, 3, "cuda", 1.0)
    (dx, dw), (dx2, dw2) = RMS.rmsnorm_bwd(x, w, g, 1e-5), RMS.rmsnorm_bwd(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(dx.view(torch.int16 if dt == "bf16" else torch.int32),
                       dx2.view(torch.int16 if dt == "bf16" else torch.int32))
    assert torch.equal(dw.view(torch.int32), dw2.view(torch.int32))


@pytest.mark.cuda
def test_bf16_loss_backward_runs_on_the_tensor_core_instance():
    """``loss_and_grads`` casts the weights to bf16: every flash backward of
    a reduced dense model's step is a tensor-core launch."""
    _cuda()
    from repro_torch.train import loss_and_grads

    cfg = get_arch("llama3-8b").with_reduced()
    params = build_model(cfg).init(0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab, (2, 65))).cuda()
    tc, fp32 = FA.flash_attention_bwd.launches_tc, FA.flash_attention_bwd.launches_fp32
    loss_and_grads(build_model(cfg), params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd.launches_tc - tc == cfg.n_layers
    assert FA.flash_attention_bwd.launches_fp32 == fp32
