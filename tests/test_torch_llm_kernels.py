"""The port's LLM kernels on the CPU against the reference's.

The port's plain flash attention, RMSNorm and decode attention (what the
kernel wrappers and ``kernels/ops.py`` run for CPU tensors) against the
reference's Pallas kernels in interpret mode and its jnp oracles, on the
shapes, masks and dtypes of ``tests/test_kernels.py`` and on ``q_offset``
cases.  Inputs are drawn with numpy from fixed seeds and handed to both.

The mirror of the bf16 tensor-core flash kernel's arithmetic
(``ref.flash_attention_tc_reference``: P split into bf16 hi + lo, the softmax
in base 2) is held to the Pallas kernel and the oracle at the bf16 tolerance, on
every mask, head dims 16-128 and ragged S and T.

Tolerances: attention fp32 2e-6 and bf16 2e-2 (``tests/test_kernels.py``);
RMSNorm fp32 1e-6, bf16 one bf16 unit in the last place; decode attention
fp32 1e-5 (the reference's decode-vs-full tolerance) and bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention as flash_wrapper
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_wrapper

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-6), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, B, S, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32) * 0.5,
            rng.standard_normal((B, T, KV, D), dtype=np.float32) * 0.5,
            rng.standard_normal((B, T, KV, D), dtype=np.float32) * 0.5)


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,S,H,KV,D,qb,kb",
    [
        (1, 128, 4, 4, 32, 64, 64),    # MHA
        (2, 256, 8, 2, 16, 64, 128),   # GQA 4:1, rectangular blocks
        (1, 192, 4, 1, 64, 64, 64),    # MQA, non-divisible seq (padding)
    ],
)
def test_flash_plain_matches_pallas_and_oracle(B, S, H, KV, D, qb, kb, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(S + D, B, S, S, H, KV, D), dtype)
    tol = DTYPES[dtype][2]
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, q_block=qb, kv_block=kb, interpret=True)
    oracle = jref.attention_reference(jq, jk, jv, causal=True)
    got = ref.flash_attention_reference(q, k, v, causal=True, q_block=qb, kv_block=kb)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    naive = ref.attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(_np(naive), _np(oracle), atol=tol, rtol=tol)


MASKS = {
    "window": dict(causal=True, window=96),
    "chunk": dict(causal=True, chunk=64),
    "bidir": dict(causal=False),
}


@pytest.mark.parametrize("variant", sorted(MASKS))
def test_flash_plain_mask_variants(variant):
    (jq, jk, jv), (q, k, v) = _both(_qkv(7, 2, 256, 256, 4, 2, 32), "fp32")
    kw = MASKS[variant]
    pallas = flash_attention_pallas(jq, jk, jv, q_block=64, kv_block=64, interpret=True, **kw)
    got = ref.flash_attention_reference(q, k, v, q_block=64, kv_block=64, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(_np(ref.attention_reference(q, k, v, **kw)),
                               _np(jref.attention_reference(jq, jk, jv, **kw)), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(S=64, T=192, q_offset=128),                     # the last 64 positions of 192
    dict(S=100, T=256, q_offset=156, window=48),         # non-divisible S, window
    dict(S=96, T=160, q_offset=64, chunk=32),            # chunked, offset across chunks
])
def test_flash_plain_q_offset(case, dtype):
    case = dict(case)
    S, T = case.pop("S"), case.pop("T")
    (jq, jk, jv), (q, k, v) = _both(_qkv(S * T, 2, S, T, 4, 2, 32), dtype)
    tol = DTYPES[dtype][2]
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, q_block=32, kv_block=64,
                                    interpret=True, **case)
    oracle = jref.attention_reference(jq, jk, jv, causal=True, **case)
    got = ref.flash_attention_reference(q, k, v, causal=True, q_block=32, kv_block=64, **case)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


TC_CASES = {  # (S, T, D, masks) for the tensor-core mirror
    "causal D16": (256, 256, 16, dict(causal=True)),
    "causal D32": (128, 128, 32, dict(causal=True)),
    "window D64": (256, 256, 64, dict(causal=True, window=96)),
    "chunk D128": (256, 256, 128, dict(causal=True, chunk=64)),
    "q_offset S<T D64": (100, 300, 64, dict(causal=True, q_offset=200)),
    "chunk and q_offset D32": (96, 160, 32, dict(causal=True, chunk=32, q_offset=64)),
    "not causal ragged T D32": (129, 77, 32, dict(causal=False)),
    "ragged S=T=333 window D16": (333, 333, 16, dict(causal=True, window=100)),
}


@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_flash_tc_mirror_matches_pallas_and_oracle(name):
    S, T, D, kw = TC_CASES[name]
    (jq, jk, jv), (q, k, v) = _both(_qkv(S + T + D, 2, S, T, 4, 2, D), "bf16")
    got = ref.flash_attention_tc_reference(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    pallas = flash_attention_pallas(jq, jk, jv, q_block=64, kv_block=64, interpret=True, **kw)
    oracle = jref.attention_reference(jq, jk, jv, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    plain = ref.flash_attention_reference(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(plain), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_flash_tc_mirror_multiplies_p_as_the_plain_version_does(name):
    """P enters the product with V as bf16 hi + lo, close to the fp32 of the
    plain version and the Pallas kernel: at most 1 in 100 bf16 outputs
    differ from the plain version's (P rounded to bf16 alone: ~40%)."""
    S, T, D, kw = TC_CASES[name]
    _, (q, k, v) = _both(_qkv(S + T + D, 2, S, T, 4, 2, D), "bf16")
    got = ref.flash_attention_tc_reference(q, k, v, **kw)
    plain = ref.flash_attention_reference(q, k, v, **kw)
    assert float((got != plain).float().mean()) <= 0.01


def test_flash_dispatch_on_cpu_runs_the_plain_version():
    _, (q, k, v) = _both(_qkv(3, 1, 96, 96, 4, 2, 16), "fp32")
    want = ref.flash_attention_reference(q, k, v, causal=True, window=40)
    before = flash_wrapper.launches
    for got in (flash_wrapper(q, k, v, causal=True, window=40),
                ops.flash_attention(q, k, v, window=40, impl="auto"),
                ops.flash_attention(q, k, v, window=40, impl="reference", q_block=32, kv_block=32)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=2e-6)
    assert flash_wrapper.launches == before  # no kernel on the host


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (17, 256)])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    want = _np(rmsnorm_pallas(jnp.asarray(x, jdt), jnp.asarray(w), interpret=True, rows_block=8))
    got = ref.rmsnorm_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == shape
    oracle = _np(jref.rmsnorm_reference(jnp.asarray(x, jdt), jnp.asarray(w)))
    for other in (want, oracle):
        if dtype == "fp32":
            np.testing.assert_allclose(_np(got), other, atol=1e-6, rtol=1e-6)
        else:
            assert (np.abs(_np(got) - other) <= _bf16_ulp(other)).all()


def test_rmsnorm_dispatch_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 1, 96), dtype=np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal(96, dtype=np.float32))
    want = ref.rmsnorm_reference(x, w, 1e-6)
    before = rmsnorm_wrapper.launches
    for got in (rmsnorm_wrapper(x, w, 1e-6), ops.rmsnorm(x, w, 1e-6),
                ops.rmsnorm(x, w, 1e-6, impl="reference")):
        assert torch.equal(got, want)
    assert rmsnorm_wrapper.launches == before


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("masks", [{}, {"window": 16}, {"chunk": 24}])
@pytest.mark.parametrize("pos", [0, 40, 63])
def test_decode_attention_matches_reference(pos, masks, dtype):
    rng = np.random.default_rng(pos + 100 * len(masks))
    B, T, H, KV, D = 2, 64, 4, 2, 16
    q = rng.standard_normal((B, H, D), dtype=np.float32) * 0.5
    kc = rng.standard_normal((B, T, KV, D), dtype=np.float32) * 0.5
    vc = rng.standard_normal((B, T, KV, D), dtype=np.float32) * 0.5
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    want = jref.decode_attention_reference(jq, jk, jv, jnp.asarray(pos), **masks)
    tol = 1e-5 if dtype == "fp32" else 2e-2
    for p in (pos, torch.tensor(pos)):
        got = ref.decode_attention_reference(tq, tk, tv, p, **masks)
        assert got.dtype == tq.dtype and got.shape == (B, H, D)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
