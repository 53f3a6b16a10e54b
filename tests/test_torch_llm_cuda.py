"""The LLM kernels and the dense model: no quiet fallback to the host, and
each kernel against its plain version on the card.

This file imports neither JAX nor the reference package, so its ``cuda``
tests run on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_llm_cuda.py

Tolerances on the card: flash attention fp32 2e-6 and bf16 2e-2
(``tests/test_kernels.py``); RMSNorm fp32 1e-6, bf16 one bf16 unit in the
last place; the SSD scan fp32 1e-5 (``tests/test_kernels.py``), bf16 ``y``
2e-2, and its fp32 final state 1e-5, or 1e-4 at chunks of 256 (the
cumulative sums of ``dt * A`` there reach ~10^2, and the plain version's
parallel ``torch.cumsum`` and the kernel's in-order sum part by a few units
in their last place, ~1e-5 of every decay).

The bf16 instances (tensor cores) are also held to the plain mirrors of their
own arithmetic (``ref.flash_attention_tc_reference``,
``ref.ssd_chunked_reference``) at a tight tolerance: every element within two
bf16 units in the last place of the mirror's value plus 1e-3, but for at most
one in 10^5 elements, which must be within 2e-2 of it.  The two sum in other
orders, so the bf16 rounding of an output may fall the other way, and an
operand split into bf16 hi + lo (P; the SSD's S_in and CB o L o dt) may
split at another point.  An indexing fault moves
whole rows or tiles.  The SSD final state: 1e-5 (both take the cumulative
sums in the same order).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import build_model
from repro_torch.serve import greedy_generate


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _qkv(device, dtype=torch.float32, B=1, S=64, T=64, H=4, KV=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.5).to(device, dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


def test_impl_cuda_on_cpu_tensors_raises():
    q, k, v = _qkv("cpu")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.flash_attention(q, k, v, impl="cuda")
    x, w = torch.ones(3, 8), torch.ones(8)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.rmsnorm(x, w, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rmsnorm(x, w, impl="pallas")


def test_wrappers_refuse_mixed_or_unsupported_devices():
    q, k, v = _qkv("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(torch.ones(2, 8, device="meta"), torch.ones(8, device="meta"))
    x, dt, A, Bm, Cm, _ = _ssd_inputs("cpu", torch.float32, 1, 16, 2, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt, A, Bm, Cm.to("meta"), chunk=8)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=8, impl="cuda")


def test_bare_model_init_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    model = build_model(get_arch("llama3-8b").with_reduced())
    assert model.attn_impl == "auto"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0, device="cuda:0")
    params = model.init(0, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_model_on_cpu_stays_on_cpu_and_launches_nothing():
    model = build_model(get_arch("glm4-9b").with_reduced())
    params = model.init(1, device="cpu")
    before = (flash_attention.launches, rmsnorm.launches)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(2, 256, (2, 9)))
    logits = model.forward_step(params, {"tokens": tokens})
    assert logits.shape == (2, 8, 256) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    new = greedy_generate(model, params, tokens[:, :4], max_new_tokens=3)
    assert new.shape == (2, 3) and new.device.type == "cpu"
    assert (flash_attention.launches, rmsnorm.launches) == before


def test_mamba_on_cpu_stays_on_cpu_and_launches_nothing():
    model = build_model(get_arch("mamba2-2.7b").with_reduced())
    params = model.init(3, device="cpu")
    before = (ssd_scan.launches, rmsnorm.launches)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(2, 256, (2, 33)))
    logits = model.forward_step(params, {"tokens": tokens})
    assert logits.shape == (2, 32, 256) and torch.isfinite(logits.float()).all()
    new = greedy_generate(model, params, tokens[:, :4], max_new_tokens=3)
    assert new.shape == (2, 3) and new.device.type == "cpu"
    assert (ssd_scan.launches, rmsnorm.launches) == before


def _instance_counts(wrapper):
    return wrapper.launches, wrapper.launches_tc, wrapper.launches_fp32


def _one_more(counts, dtype):
    """The counts after one launch of the instance of ``dtype``: the
    tensor-core one for bf16, the CUDA-core one for fp32."""
    total, tc, fp32 = counts
    return (total + 1, tc + 1, fp32) if dtype == torch.bfloat16 else (total + 1, tc, fp32 + 1)


def _tc_close(got, want):
    """The tensor-core kernels against the mirrors of their arithmetic: every
    element within two bf16 units in the last place of ``want`` plus 1e-3,
    but for at most one in 10^5, within 2e-2."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    d = (got.float() - w).abs()
    beyond = int((d > 2 * ulp + 1e-3).sum())
    assert beyond <= d.numel() // 100_000, f"{beyond} of {d.numel()} beyond two ulps + 1e-3"
    torch.testing.assert_close(got.float(), w, atol=2e-2, rtol=2e-2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


FLASH_CASES = [
    dict(S=128, T=128, H=4, KV=4, D=32),
    dict(S=192, T=192, H=4, KV=1, D=64, causal=True),
    dict(S=100, T=300, H=8, KV=2, D=128, q_offset=200),
    dict(S=256, T=256, H=4, KV=2, D=16, window=96),
    dict(S=256, T=256, H=4, KV=2, D=32, chunk=64),
    dict(S=129, T=77, H=2, KV=2, D=64, causal=False),
    dict(S=333, T=333, H=8, KV=2, D=128, window=100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_version(case, dtype, tol):
    _cuda()
    case = dict(case)
    shape = {n: case.pop(n) for n in ("S", "T", "H", "KV", "D")}
    q, k, v = _qkv("cuda", dtype, B=2, seed=shape["S"], **shape)
    before = _instance_counts(flash_attention)
    got = flash_attention(q, k, v, **case)
    torch.cuda.synchronize()
    assert _instance_counts(flash_attention) == _one_more(before, dtype)
    want = ref.flash_attention_reference(q, k, v, **case)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_tc_kernel_matches_its_mirror(case):
    _cuda()
    case = dict(case)
    shape = {n: case.pop(n) for n in ("S", "T", "H", "KV", "D")}
    q, k, v = _qkv("cuda", torch.bfloat16, B=2, seed=shape["S"] + 1, **shape)
    got = flash_attention(q, k, v, **case)
    _tc_close(got, ref.flash_attention_tc_reference(q, k, v, **case))


# whisper-tiny's non-causal launches: its encoder's self-attention over
# T = 1500 = 11 * 128 + 92 frames, and the decoder's 448 positions over them
WHISPER_FLASH_CASES = [
    dict(B=8, S=1500, T=1500, H=6, KV=6, D=64),
    dict(B=8, S=448, T=1500, H=6, KV=6, D=64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", WHISPER_FLASH_CASES, ids=lambda c: f"S{c['S']}-T{c['T']}")
def test_flash_kernel_not_causal_at_whisper_shapes(shape, dtype, tol):
    """No key past T reaches the softmax: the kernel masks the padded
    columns of the last key tile itself when no causal mask hides them."""
    _cuda()
    q, k, v = _qkv("cuda", dtype, seed=shape["S"] + 2, **shape)
    before = _instance_counts(flash_attention)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert _instance_counts(flash_attention) == _one_more(before, dtype)
    want = ref.flash_attention_reference(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        _tc_close(got, ref.flash_attention_tc_reference(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (17, 4096), (4, 1, 5376), (2, 12288), (5, 4097)])
def test_rmsnorm_kernel_matches_plain_version(shape, dtype):
    _cuda()
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
    w = torch.from_numpy(rng.standard_normal(shape[-1:], dtype=np.float32)).cuda()
    before = rmsnorm.launches
    got = rmsnorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    want = ref.rmsnorm_reference(x, w, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    else:
        w_ = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w_.abs().clamp_min(1e-30))) - 7)
        assert ((got.float() - w_).abs() <= ulp).all()


def _ssd_inputs(device, dtype, B, L, H, P, G, N, seed=0, init=False):
    """x, dt (softplus of a normal draw), A = -exp(...), Bm, Cm and an
    initial state (or None); x/B/C in ``dtype``, the rest fp32."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)

    x = t((B, L, H, P), 0.5).to(device, dtype)
    dt = torch.nn.functional.softplus(t((B, L, H))).to(device)
    A = -torch.exp(t((H,), 0.3)).to(device)
    Bm = t((B, L, G, N), 0.3).to(device, dtype)
    Cm = t((B, L, G, N), 0.3).to(device, dtype)
    state = t((B, H, P, N)).to(device) if init else None
    return x, dt, A, Bm, Cm, state


SSD_CASES = [
    # (B, L, H, P, G, N, chunk, dtype, initial state)
    (2, 4096, 80, 64, 1, 128, 256, torch.bfloat16, False),  # the mamba2-2.7b prefill
    (2, 256, 80, 64, 1, 128, 256, torch.bfloat16, False),   # a single chunk
    (2, 1024, 8, 64, 2, 128, 256, torch.bfloat16, False),   # G > 1, H/G = 4
    (2, 1024, 16, 64, 1, 128, 256, torch.bfloat16, True),   # a nonzero initial state
    (1, 2048, 80, 64, 1, 128, 256, torch.bfloat16, False),  # B = 1
    (2, 512, 8, 64, 2, 128, 64, torch.bfloat16, True),      # chunk 64, G > 1, initial state
    (1, 512, 6, 128, 3, 64, 128, torch.bfloat16, False),    # chunk 128, P = 128, N = 64
    (1, 64, 2, 8, 1, 16, 16, torch.float32, False),         # tests/test_kernels.py
    (2, 128, 4, 16, 2, 32, 32, torch.float32, False),
    (1, 96, 8, 8, 4, 8, 32, torch.float32, False),
    (1, 288, 6, 80, 3, 10, 96, torch.float32, True),        # P > 64, N % 4 != 0, chunk 96
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c[:7])) + f"-{c[7]}-{c[8]}")
def test_ssd_kernel_matches_plain_version(case):
    _cuda()
    B, L, H, P, G, N, chunk, dtype, init = case
    x, dt, A, Bm, Cm, state = _ssd_inputs("cuda", dtype, B, L, H, P, G, N, seed=L + H, init=init)
    before = _instance_counts(ssd_scan)
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=state)
    torch.cuda.synchronize()
    assert _instance_counts(ssd_scan) == _one_more(before, dtype)
    want_y, want_st = ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=state)
    assert y.dtype == dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    st_tol = 1e-4 if chunk >= 256 else 1e-5
    torch.testing.assert_close(st, want_st, atol=st_tol, rtol=st_tol)


@pytest.mark.cuda
def test_ssd_kernel_takes_strided_dt_and_refuses_a_ragged_chunk():
    _cuda()
    x, dt, A, Bm, Cm, _ = _ssd_inputs("cuda", torch.float32, 2, 128, 4, 16, 2, 32)
    dt_t = dt.transpose(0, 1).contiguous().transpose(0, 1)  # (B, L, H) with L outermost
    assert not dt_t.is_contiguous()
    y, st = ssd_scan(x, dt_t, A, Bm, Cm, chunk=32)
    want_y, want_st = ref.ssd_reference(x, dt, A, Bm, Cm, chunk=32)
    torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(st, want_st, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=48)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in SSD_CASES if c[7] == torch.bfloat16],
                         ids=lambda c: "-".join(map(str, c[:7])) + f"-{c[8]}")
def test_ssd_tc_kernel_matches_its_mirror(case):
    _cuda()
    B, L, H, P, G, N, chunk, dtype, init = case
    x, dt, A, Bm, Cm, state = _ssd_inputs("cuda", dtype, B, L, H, P, G, N, seed=L + 1, init=init)
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=state)
    want_y, want_st = ref.ssd_chunked_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=state)
    _tc_close(y, want_y)
    torch.testing.assert_close(st, want_st, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width_pad", [0, 3])
def test_ssd_tc_kernel_on_views_of_the_in_projection(width_pad):
    """x, B, C and dt as strided views of one projection, as a fused
    in-projection gives them (width_pad = 3: row strides that are no multiple
    of 8 elements, which the wrapper copies before the kernel's 16-byte
    copies); the result equals the call on contiguous copies."""
    _cuda()
    Bsz, L, H, P, G, N = 2, 512, 8, 64, 2, 128
    rng = np.random.default_rng(7)
    width = H * P + 2 * G * N + H + width_pad
    proj = torch.from_numpy(rng.standard_normal((Bsz, L, width), dtype=np.float32) * 0.3)
    proj = proj.to("cuda", torch.bfloat16)
    x = proj[..., :H * P].unflatten(-1, (H, P))
    Bm = proj[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = proj[..., H * P + G * N:H * P + 2 * G * N].unflatten(-1, (G, N))
    dt = torch.nn.functional.softplus(proj[..., H * P + 2 * G * N:H * P + 2 * G * N + H].float())
    A = -torch.exp(torch.from_numpy(rng.standard_normal(H, dtype=np.float32) * 0.3)).cuda()
    assert not x.is_contiguous() and not Bm.is_contiguous()
    before = _instance_counts(ssd_scan)
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    assert _instance_counts(ssd_scan) == _one_more(before, torch.bfloat16)
    y_c, st_c = ssd_scan(*(t.contiguous() for t in (x, dt, A, Bm, Cm)), chunk=128)
    assert torch.equal(y, y_c) and torch.equal(st, st_c)
    want_y, want_st = ref.ssd_reference(x, dt, A, Bm, Cm, chunk=128)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(st, want_st, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_ssd_tc_kernel_refuses_shapes_it_is_not_built_for():
    _cuda()
    x, dt, A, Bm, Cm, _ = _ssd_inputs("cuda", torch.bfloat16, 1, 96, 2, 64, 1, 128)
    with pytest.raises(ValueError, match="bf16 kernel takes chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=32)  # the fp32 instance takes it; bf16 never goes there
    x, dt, A, Bm, Cm, _ = _ssd_inputs("cuda", torch.bfloat16, 1, 128, 2, 64, 1, 16)
    with pytest.raises(ValueError, match="bf16 kernel takes chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=64)
