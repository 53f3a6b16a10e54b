"""The plain backward versions of the port against the reference's autodiff,
on the CPU.

``ref.flash_attention_bwd_reference`` (the plain version of
``csrc/flash_attention_bwd.cu``) is held to ``jax.vjp`` of the reference's
``flash_attention_jnp``, which runs its custom VJP (``_flash_bwd_impl``),
in fp32 at atol = rtol = 1e-5, on seeded numpy inputs: GQA, causal,
window, chunk, q_offset > 0, non-causal S != T with T = 128 + 92, and
blocks that divide neither S nor T.  The wrapper's gradient on the host
(``ref.FlashAttentionVJP``, the reference's custom VJP on the plain forward
and that backward; ``kernels/flash_attention.py::FlashAttention`` is its
counterpart on the card) is held to the same, and to
``torch.autograd.gradcheck`` in float64 at one tiny shape.
``ref.rmsnorm_bwd_reference`` (the plain version of ``csrc/rmsnorm_bwd.cu``)
and the RMSNorm Function are held to ``jax.vjp`` of the reference's
``rmsnorm_reference``: fp32 1e-6, bf16 2e-2 (the tolerances of
``tests/test_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RMS

TOL = 1e-5

# (name, B, S, T, H, KV, D, masks, q_block, kv_block)
CASES = (
    ("GQA causal", 2, 64, 64, 4, 2, 16, dict(causal=True), 16, 16),
    ("window", 1, 72, 72, 4, 2, 16, dict(causal=True, window=20), 24, 16),
    ("chunk", 1, 64, 64, 4, 1, 32, dict(causal=True, chunk=16), 16, 32),
    ("q_offset > 0, S < T", 1, 32, 64, 4, 2, 16, dict(causal=True, q_offset=32), 16, 16),
    ("not causal, S != T, T = 128 + 92", 1, 40, 220, 2, 2, 16, dict(causal=False), 32, 64),
    ("blocks divide neither S nor T", 2, 50, 50, 4, 2, 16, dict(causal=True), 16, 24),
    ("window and q_offset", 1, 48, 80, 2, 1, 16, dict(causal=True, window=30, q_offset=32), 16, 32),
)


def _inputs(B, S, T, H, KV, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s, dtype=np.float32) * 0.5).astype(dtype)
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D), (B, S, H, D))]


def _ref_vjp(q, k, v, g, masks, q_block, kv_block):
    f = lambda q, k, v: RK.flash_attention_jnp(q, k, v, q_block=q_block, kv_block=kv_block, **masks)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_reference_matches_the_references_custom_vjp(case):
    name, B, S, T, H, KV, D, masks, qb, kb = case
    q, k, v, g = _inputs(B, S, T, H, KV, D)
    want_out, want = _ref_vjp(q, k, v, g, masks, qb, kb)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    m = dict(masks)
    out, lse = ref._flash_fwd_impl(tq, tk, tv, m.pop("causal"), m.pop("window", None),
                                   m.pop("chunk", None), qb, kb, m.pop("q_offset", 0))
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    got = ref.flash_attention_bwd_reference(tq, tk, tv, out, lse, tg, q_block=qb, kv_block=kb, **masks)
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL, err_msg=f"{name}: {what}")


@pytest.mark.parametrize("case", CASES[::2], ids=[c[0] for c in CASES[::2]])
def test_flash_function_matches_the_references_custom_vjp(case):
    """The wrapper's gradient (plain forward and backward on the host,
    default blocking) against the reference's custom VJP."""
    name, B, S, T, H, KV, D, masks, _, _ = case
    q, k, v, g = _inputs(B, S, T, H, KV, D, seed=1)
    _, want = _ref_vjp(q, k, v, g, masks, 512, 512)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = FA.flash_attention(tq, tk, tv, **masks)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL, err_msg=f"{name}: {what}")


def test_flash_function_gradcheck_float64():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 5, 2, 8), (1, 6, 1, 8), (1, 6, 1, 8)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FA.flash_attention(q, k, v, causal=True, window=3, q_offset=1), (q, k, v))
    assert torch.autograd.gradcheck(lambda q, k, v: FA.flash_attention(q, k, v, causal=False), (q, k, v))


def test_rmsnorm_function_gradcheck_float64():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 4, 10))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal(10)).requires_grad_()
    assert torch.autograd.gradcheck(lambda x, w: RMS.rmsnorm(x, w, 1e-5), (x, w))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(6, 40), (2, 3, 64), (5, 33)])
def test_rmsnorm_bwd_matches_the_references_vjp(shape, dtype, tol):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    _, vjp = jax.vjp(lambda x, w: RK.rmsnorm_reference(x, w, 1e-5), jnp.asarray(x, jd), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(g, jd)))
    tx, tw, tg = torch.from_numpy(x).to(td), torch.from_numpy(w), torch.from_numpy(g).to(td)
    dx, dw = ref.rmsnorm_bwd_reference(tx, tw, tg, 1e-5)
    assert dx.dtype == td and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=tol, rtol=tol)
    np.testing.assert_allclose(dw.numpy(), want_dw, atol=tol, rtol=tol)
    # the Function at the wrapper
    tx.requires_grad_()
    tw.requires_grad_()
    fdx, fdw = torch.autograd.grad(RMS.rmsnorm(tx, tw, 1e-5), (tx, tw), tg)
    assert torch.equal(fdx, dx) and torch.equal(fdw, dw)
