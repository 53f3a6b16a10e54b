"""The port's Mamba-2 SSD on the CPU against the reference's.

``_segsum``, ``ssd_reference`` and ``ssd_decode_step`` of the port (what the
kernel wrapper and ``kernels/ops.py`` run for CPU tensors) against
``repro.kernels.ref`` and against ``ssd_pallas`` in interpret mode, on the
shapes of ``tests/test_kernels.py`` and with a nonzero initial state.
Inputs are drawn with numpy from fixed seeds and handed to both.

Tolerances: fp32 1e-5 atol = rtol (what ``tests/test_kernels.py`` holds
``ssd_pallas`` to); bf16 x/B/C 2e-2; the sequential decode against the
chunked scan 1e-4 (``tests/test_kernels.py``); the chunk sizes against each
other 1e-5.  The mirror of the bf16 tensor-core kernel's arithmetic
(``ref.ssd_chunked_reference``) is held to the reference and to
``ssd_pallas`` with bf16 x, B and C at 2e-2 for y and, for the final state,
1e-4 at chunks of 256 and 1e-5 below (the in-order cumulative sums of
``dt * A`` reach ~10^2 at 256 and part from the reference's by a few units
in their last place).  The kernel itself is held to this plain version on the card by
``tests/test_torch_llm_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan

SHAPES = [(1, 64, 2, 8, 1, 16, 16), (2, 128, 4, 16, 2, 32, 32), (1, 96, 8, 8, 4, 8, 32)]
TOL = 1e-5


def _inputs(seed, B, L, H, P, G, N):
    """x, dt (softplus of a normal draw), A (negative), Bm, Cm as fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H), dtype=np.float32)))
    A = -np.exp(rng.standard_normal((H,), dtype=np.float32) * 0.3)
    Bm = rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3
    return x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(5,), (3, 16), (2, 4, 32)])
def test_segsum_matches_reference(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape, dtype=np.float32)
    want = np.asarray(jref._segsum(jnp.asarray(x)))
    got = ref._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SHAPES)
def test_ssd_plain_matches_reference_and_pallas(B, L, H, P, G, N, chunk):
    arrays = _inputs(L + H, B, L, H, P, G, N)
    j = [jnp.asarray(a) for a in arrays]
    y1, s1 = jref.ssd_reference(*j, chunk=chunk)
    y2, s2 = ssd_pallas(*j, chunk=chunk, interpret=True)
    y, s = ref.ssd_reference(*_t(*arrays), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, L, H, P)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, P, N)
    for want_y, want_s in ((y1, s1), (y2, s2)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(_np(s), _np(want_s), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SHAPES)
def test_ssd_plain_initial_state_matches_reference(B, L, H, P, G, N, chunk):
    arrays = _inputs(7 * L, B, L, H, P, G, N)
    init = np.random.default_rng(L).standard_normal((B, H, P, N), dtype=np.float32)
    want_y, want_s = jref.ssd_reference(*[jnp.asarray(a) for a in arrays], chunk=chunk,
                                        initial_state=jnp.asarray(init))
    # the TPU wrapper sends a nonzero initial state to the reference path
    pal_y, _ = ssd_pallas(*[jnp.asarray(a) for a in arrays], chunk=chunk,
                          initial_state=jnp.asarray(init), interpret=True)
    y, s = ops.ssd(*_t(*arrays), chunk=chunk, initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(_np(y), _np(want_y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(y), _np(pal_y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(s), _np(want_s), atol=TOL, rtol=TOL)
    zero_y, _ = ref.ssd_reference(*_t(*arrays), chunk=chunk)
    assert not np.allclose(_np(zero_y), _np(y), atol=TOL, rtol=TOL)  # the state matters


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SHAPES)
def test_ssd_plain_bf16_matches_reference(B, L, H, P, G, N, chunk):
    x, dt, A, Bm, Cm = _inputs(3 * L, B, L, H, P, G, N)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm)]
    want_y, want_s = jref.ssd_reference(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1], jb[2],
                                        chunk=chunk)
    tx, tB, tC = _t(x, Bm, Cm, dtype=torch.bfloat16)
    y, s = ref.ssd_reference(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC, chunk=chunk)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want_y), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(s), _np(want_s), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,H,P,G,N", [(2, 4, 8, 1, 16), (1, 8, 16, 4, 8), (3, 2, 4, 2, 32)])
def test_ssd_decode_step_matches_reference(B, H, P, G, N):
    rng = np.random.default_rng(B * 100 + H)
    state = rng.standard_normal((B, H, P, N), dtype=np.float32)
    x = rng.standard_normal((B, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H), dtype=np.float32))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,), dtype=np.float32) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, G, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, G, N), dtype=np.float32) * 0.3
    want_y, want_s = jref.ssd_decode_step(*[jnp.asarray(a) for a in (state, x, dt, A, Bm, Cm)])
    y, s = ref.ssd_decode_step(*_t(state, x, dt, A, Bm, Cm))
    np.testing.assert_allclose(_np(y), _np(want_y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(s), _np(want_s), atol=TOL, rtol=TOL)
    # bf16 x and B/C, as the model's decode hands them in: y in bf16, the state fp32
    yb, sb = ref.ssd_decode_step(torch.from_numpy(state), *_t(x, dtype=torch.bfloat16),
                                 torch.from_numpy(dt), torch.from_numpy(A),
                                 *_t(Bm, Cm, dtype=torch.bfloat16))
    wyb, wsb = jref.ssd_decode_step(jnp.asarray(state), jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(dt), jnp.asarray(A),
                                    jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16))
    assert yb.dtype == torch.bfloat16 and sb.dtype == torch.float32
    np.testing.assert_allclose(_np(yb), _np(wyb), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(sb), _np(wsb), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_is_the_same_function_at_any_chunk(seed):
    """SSD at chunk 8 and chunk 32 on the same inputs: only the order of
    summation differs."""
    arrays = _inputs(seed, 2, 64, 4, 8, 2, 16)
    y8, s8 = ref.ssd_reference(*_t(*arrays), chunk=8)
    y32, s32 = ref.ssd_reference(*_t(*arrays), chunk=32)
    np.testing.assert_allclose(_np(y8), _np(y32), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(s8), _np(s32), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_sequential_decode_reproduces_the_chunked_scan(G):
    B, L, H, P, N = 1, 32, 2, 4, 8
    x, dt, A, Bm, Cm = _t(*_inputs(11 + G, B, L, H, P, G, N))
    y, final = ref.ssd_reference(x, dt, A, Bm, Cm, chunk=8)
    st = torch.zeros((B, H, P, N))
    for t in range(L):
        yt, st = ref.ssd_decode_step(st, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        np.testing.assert_allclose(yt.numpy(), y[:, t].numpy(), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), final.numpy(), atol=1e-4)


def test_impl_cuda_on_cpu_tensors_raises():
    x, dt, A, Bm, Cm = _t(*_inputs(0, 1, 16, 2, 4, 1, 8))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=8, impl="pallas")


@pytest.mark.parametrize("impl", ["auto", "reference"])
@pytest.mark.parametrize("chunk", [5, 0])
def test_a_chunk_that_does_not_divide_the_sequence_raises(impl, chunk):
    x, dt, A, Bm, Cm = _t(*_inputs(0, 1, 16, 2, 4, 1, 8))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, impl=impl)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    arrays = _t(*_inputs(4, 2, 32, 4, 8, 2, 16))
    init = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 4, 8, 16), dtype=np.float32))
    before = ssd_scan.launches
    y, s = ssd_scan(*arrays, chunk=16, initial_state=init)
    want_y, want_s = ref.ssd_reference(*arrays, chunk=16, initial_state=init)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert ssd_scan.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*arrays[:4], arrays[4].to("meta"), chunk=16)


TC_SHAPES = [  # (B, L, H, P, G, N, chunk, initial state): the bf16 kernel's chunks
    (1, 512, 4, 64, 1, 128, 256, False),
    (1, 512, 4, 64, 1, 64, 256, True),
    (2, 256, 4, 64, 2, 64, 128, True),
    (1, 192, 4, 64, 2, 64, 64, False),
]


@pytest.mark.parametrize("case", TC_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunked_mirror_matches_reference_and_pallas(case):
    B, L, H, P, G, N, chunk, with_init = case
    x, dt, A, Bm, Cm = _inputs(L + chunk, B, L, H, P, G, N)
    init = (np.random.default_rng(chunk).standard_normal((B, H, P, N), dtype=np.float32)
            if with_init else None)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm)]
    jinit = None if init is None else jnp.asarray(init)
    want = [jref.ssd_reference(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1], jb[2], chunk=chunk,
                               initial_state=jinit),
            ssd_pallas(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1], jb[2], chunk=chunk,
                       initial_state=jinit, interpret=True)]
    tx, tB, tC = _t(x, Bm, Cm, dtype=torch.bfloat16)
    y, s = ref.ssd_chunked_reference(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                                     chunk=chunk,
                                     initial_state=None if init is None else torch.from_numpy(init))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32 and s.shape == (B, H, P, N)
    st_tol = 1e-4 if chunk >= 256 else 1e-5
    for want_y, want_s in want:
        np.testing.assert_allclose(_np(y), _np(want_y), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(_np(s), _np(want_s), atol=st_tol, rtol=st_tol)


@pytest.mark.parametrize("case", TC_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunked_mirror_multiplies_as_the_plain_version_does(case):
    """S_in and CB o L o dt enter their products as bf16 hi + lo, close to
    the fp32 of the plain version and the Pallas kernel: at most 1 in 100
    bf16 outputs differ from the plain version's (each rounded to bf16
    alone: ~1 in 3)."""
    B, L, H, P, G, N, chunk, with_init = case
    x, dt, A, Bm, Cm = _inputs(L + chunk, B, L, H, P, G, N)
    init = (torch.from_numpy(np.random.default_rng(chunk).standard_normal((B, H, P, N),
                                                                          dtype=np.float32))
            if with_init else None)
    tx, tB, tC = _t(x, Bm, Cm, dtype=torch.bfloat16)
    args = (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC)
    y, _ = ref.ssd_chunked_reference(*args, chunk=chunk, initial_state=init)
    plain, _ = ref.ssd_reference(*args, chunk=chunk, initial_state=init)
    assert float((y != plain).float().mean()) <= 0.01
