"""The arithmetic of the bf16 SSD backward on the tensor cores, on the CPU.

``ref.ssd_bwd_tc_reference`` mirrors ``csrc/ssd_scan_bwd_sm90.cu``: C·Bᵀ once
per group, the chunks' own states with their weighted rows split into bf16
parts, one pass over the chunks for S_in and R, every fp32 operand of a
product split into bf16 hi + lo, dB and dC summed over runs of heads, and
dcs, ddA and dA in double.  On seeded numpy inputs in bf16 (x, B, C and dy)
it is held to ``jax.vjp`` of the reference's ``ssd_reference``
(``src/repro/kernels/ref.py``) and to the port's plain backward
``ref.ssd_bwd_reference`` with ``chip_smoke.py``'s tolerances for the
backward kernels (``_bwd_gap``): a bf16 gradient every element within two
bf16 units in the last place plus 1e-3 of the largest element, an fp32 one
within 1e-5 of its largest element; dA against the plain backward on the
inputs cast up to float64, within the larger of 1e-5 of its largest element
and twice the distance of the gradient it is compared with from it (dA A =
Σ_k cs_k dcs_k cancels).  The cases have the shapes the kernel takes (P 64,
N 64 or 128, chunk 64 or 128), G 1 and 2, one and several runs of heads,
initial states and final states' gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SS

NAMES = ("dx", "d_dt", "dA", "dBm", "dCm", "d_initial_state")

# (name, B, L, H, P, G, N, chunk, initial state, gradient of the final state)
CASES = (
    ("G=1, one run of heads", 1, 128, 4, 64, 1, 64, 64, False, False),
    ("G=2, states in and out", 2, 128, 4, 64, 2, 64, 64, True, True),
    ("two runs of six heads, chunk 128", 1, 256, 12, 64, 1, 64, 128, True, False),
    ("N 128, final state's gradient", 1, 128, 2, 64, 1, 128, 64, False, True),
)


def _inputs(case):
    """numpy fp32 x, dt, A, Bm, Cm, dy, the initial state and the final
    state's gradient (None where the case has none)."""
    _, B, L, H, P, G, N, chunk, init, dfin = case
    rng = np.random.default_rng(L + H + G + N)

    def draw(shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    x, dy = draw((B, L, H, P), 0.5), draw((B, L, H, P), 0.5)
    dt = np.log1p(np.exp(draw((B, L, H)))).astype(np.float32)
    A = -np.exp(draw((H,), 0.3))
    Bm, Cm = draw((B, L, G, N), 0.3), draw((B, L, G, N), 0.3)
    return x, dt, A, Bm, Cm, dy, draw((B, H, P, N)) if init else None, draw((B, H, P, N)) if dfin else None


def _torch_args(case):
    x, dt, A, Bm, Cm, dy, S0, dS = _inputs(case)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    f = lambda a: None if a is None else torch.from_numpy(a)
    return (bf(x), f(dt), f(A), bf(Bm), bf(Cm), bf(dy)), dict(chunk=case[7], initial_state=f(S0),
                                                              d_final_state=f(dS))


def _references_vjp(case):
    """The reference's gradients (jax.vjp of its ``ssd_reference`` on the
    same bf16 inputs) as torch tensors of the port's dtypes; None for the
    initial state's when there is none."""
    x, dt, A, Bm, Cm, dy, S0, dS = _inputs(case)
    chunk, init = case[7], S0 is not None
    B, L, H, P, N = x.shape[0], x.shape[1], x.shape[2], x.shape[3], Bm.shape[3]

    def f(x, dt, A, Bm, Cm, S0):
        return RK.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=S0 if init else None)

    bf = jnp.bfloat16
    prim = [jnp.asarray(x, bf), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, bf), jnp.asarray(Cm, bf),
            jnp.asarray(S0 if init else np.zeros((B, H, P, N), np.float32))]
    cot = (jnp.asarray(dy, bf), jnp.asarray(dS if dS is not None else np.zeros((B, H, P, N), np.float32)))
    grads = jax.jit(lambda prim, cot: jax.vjp(f, *prim)[1](cot))(prim, cot)
    out = [torch.from_numpy(np.array(g.astype(jnp.float32))).to(
        torch.bfloat16 if g.dtype == bf else torch.float32) for g in grads]
    if not init:
        out[-1] = None
    return out


def _held(got, want, what):
    """``_bwd_gap`` of ``chip_smoke.py``: bf16 two units in the last place +
    1e-3 x max |want|, fp32 1e-5 x max |want|."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.float(), want.float()
    d = (g - w).abs()
    scale = float(w.abs().max()) or 1.0
    if got.dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * scale, f"{what}: {float(d.max()):.3e} of {scale:.3e}"
    else:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool((d <= 2 * ulp + 1e-3 * scale).all()), f"{what}: {float(d.max()):.3e} of {scale:.3e}"


def _dA_held(got, control, exact, what):
    """dA within the larger of 1e-5 of the float64 plain version's largest
    element and twice ``control``'s distance from it."""
    err = float((got.double() - exact).abs().max())
    ctrl = float((control.double() - exact).abs().max())
    bound = max(1e-5 * float(exact.abs().max()), 2 * ctrl)
    assert err <= bound, f"{what}: {err:.3e} from float64, control {ctrl:.3e}"


@pytest.mark.parametrize("against", ["jax.vjp", "ssd_bwd_reference"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_mirror_holds_to_the_backward(case, against):
    args, kw = _torch_args(case)
    got = ref.ssd_bwd_tc_reference(*args, **kw)
    want = _references_vjp(case) if against == "jax.vjp" else list(ref.ssd_bwd_reference(*args, **kw))
    up = {k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()}
    exact_dA = ref.ssd_bwd_reference(*(a.double() for a in args), **up)[2]
    for name, g, w in zip(NAMES, got, want):
        if name == "dA":
            _dA_held(g, w, exact_dA, f"{case[0]} against {against}: dA")
        elif w is not None:
            _held(g, w, f"{case[0]} against {against}: {name}")


def test_tc_mirror_sums_heads_in_runs():
    """Heads in runs of ``ssd_bwd_head_run`` (the largest divisor of the
    heads per group up to 8): 80 heads in ten runs of 8, jamba's 256 in 32,
    12 in two of 6, a prime count one head at a time."""
    assert [ref.ssd_bwd_head_run(r) for r in (1, 2, 4, 8, 12, 80, 256, 7, 11)] == [1, 2, 4, 8, 6, 8, 8, 7, 1]


@pytest.mark.parametrize("dtype, P, N, chunk, tc", [
    (torch.bfloat16, 64, 128, 256, True),     # mamba2-2.7b, jamba
    (torch.bfloat16, 64, 64, 64, True),
    (torch.float32, 64, 128, 256, False),     # fp32 stays on the CUDA cores
    (torch.bfloat16, 24, 40, 32, False),      # ragged shapes go to the CUDA cores
    (torch.bfloat16, 80, 16, 80, False),
    (torch.bfloat16, 128, 128, 256, False),
])
def test_the_backward_shape_rule(dtype, P, N, chunk, tc):
    assert SS.bwd_on_tensor_cores(dtype, P, N, chunk) is tc
