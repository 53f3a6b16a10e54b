"""The SSD scan's backward against the reference's autodiff, on the CPU.

``ref.ssd_bwd_reference`` (the plain version of ``csrc/ssd_scan_bwd.cu``)
and the gradient of the ``SSDScan`` Function on the host (its forward the
plain ``ssd_reference``, its backward that plain backward) are held to
``jax.vjp`` of the reference's ``ssd_reference`` (``src/repro/kernels/ref.py``,
which the reference trains through), on seeded numpy inputs: G 1 and 2,
chunks 16 and 32, with and without an initial state, with a zero and a
non-zero gradient of the final state, fp32 and bf16 x, B and C.  Every
gradient within 1e-5 of its largest element (``tests/test_kernels.py``'s SSD
tolerance, applied to the gradients as ``tests/test_torch_flash_bwd.py``
applies flash attention's); a bf16 gradient (dx, dB, dC for bf16 inputs,
rounded once from fp32 on both sides) within that plus one bf16 unit in
the last place of the reference's value, since a rounding may fall the
other way.  The Function also passes ``torch.autograd.gradcheck`` in
float64 at one tiny shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SS

TOL = 1e-5
NAMES = ("dx", "d_dt", "dA", "dBm", "dCm", "d_initial_state")

# (name, B, L, H, P, G, N, chunk, initial state, gradient of the final state, dtype of x, B, C)
CASES = (
    ("G=1, no state", 1, 64, 2, 8, 1, 16, 16, False, False, "float32"),
    ("G=2, state in and out", 2, 64, 4, 8, 2, 16, 16, True, True, "float32"),
    ("chunk 32, final state's gradient", 2, 128, 4, 16, 2, 16, 32, False, True, "float32"),
    ("chunk 32, initial state", 1, 96, 4, 16, 1, 8, 32, True, False, "float32"),
    ("bf16, G=2, state in and out", 2, 64, 4, 16, 2, 16, 16, True, True, "bfloat16"),
    ("bf16, chunk 32", 1, 128, 2, 16, 1, 16, 32, False, False, "bfloat16"),
)


def _inputs(B, L, H, P, G, N, seed=0):
    """x, dt (softplus of a normal draw), A = -exp(...), Bm, Cm, an initial
    state, dy and a final state's gradient, fp32 numpy."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    x = draw((B, L, H, P), 0.5)
    dt = np.log1p(np.exp(draw((B, L, H)))).astype(np.float32)
    A = -np.exp(draw((H,), 0.3))
    Bm, Cm = draw((B, L, G, N), 0.3), draw((B, L, G, N), 0.3)
    return x, dt, A, Bm, Cm, draw((B, H, P, N)), draw((B, L, H, P)), draw((B, H, P, N))


def _case(case):
    """The reference's vjp and the port's inputs for ``case``: ``(want, args,
    kwargs)``, ``want`` the reference's six gradients (None for the initial
    state's when there is none) as fp32 numpy with the dtype they came in."""
    _, B, L, H, P, G, N, chunk, init, dfin, dtype = case
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(B, L, H, P, G, N, seed=L + H + G)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if not dfin:
        dS = np.zeros_like(dS)

    def f(x, dt, A, Bm, Cm, S0):
        return RK.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=S0 if init else None)

    def grads_of(prim, cot):
        return jax.vjp(f, *prim)[1](cot)

    prim = [jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, jd), jnp.asarray(Cm, jd),
            jnp.asarray(S0)]
    grads = jax.jit(grads_of)(prim, (jnp.asarray(dy, jd), jnp.asarray(dS)))
    want = [(np.asarray(g.astype(jnp.float32)), g.dtype) for g in grads]
    if not init:
        want[-1] = None
    t = lambda a, d=torch.float32: torch.from_numpy(np.asarray(a)).to(d)
    args = [t(x, td), t(dt), t(A), t(Bm, td), t(Cm, td)]
    kw = dict(chunk=chunk, initial_state=t(S0) if init else None, d_final_state=t(dS) if dfin else None)
    return want, args, t(dy, td), kw


def _held(got: torch.Tensor, want, what: str) -> None:
    w, wdtype = want
    g = got.float().numpy()
    scale = float(np.abs(w).max()) or 1.0
    bound = TOL * scale
    if wdtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16, what
        bound = bound + np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    else:
        assert got.dtype == torch.float32, what
    assert g.shape == w.shape, what
    err = np.abs(g - w)
    assert (err <= bound).all(), f"{what}: max abs err {err.max():.3e}, largest |value| {scale:.3e}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ssd_bwd_reference_matches_the_references_vjp(case):
    want, args, dy, kw = _case(case)
    got = ref.ssd_bwd_reference(*args, dy, **kw)
    for name, g, w in zip(NAMES, got, want):
        if w is not None:
            _held(g, w, name)


@pytest.mark.parametrize("case", CASES[1::2], ids=[c[0] for c in CASES[1::2]])
def test_ssd_function_gradient_matches_the_references_vjp(case):
    """The wrapper under grad on the host: ``SSDScan`` with the plain
    forward and backward, both outputs' gradients fed back."""
    want, args, dy, kw = _case(case)
    init = kw["initial_state"]
    leaves = [a.clone().requires_grad_() for a in args] + ([init.clone().requires_grad_()] if init is not None
                                                           else [])
    y, state = SS.ssd_scan(*leaves[:5], chunk=kw["chunk"], initial_state=leaves[5] if init is not None else None)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    outs, cots = [y], [dy]
    if kw["d_final_state"] is not None:
        outs.append(state)
        cots.append(kw["d_final_state"])
    got = torch.autograd.grad(outs, leaves, cots)
    for name, g, w in zip(NAMES, got, want):
        _held(g, w, name)


def test_ssd_function_gradcheck_float64():
    rng = np.random.default_rng(7)
    B, L, H, P, G, N, chunk = 1, 8, 2, 4, 1, 4, 4
    d = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()
    x, Bm, Cm, S0 = d(B, L, H, P), d(B, L, G, N), d(B, L, G, N), d(B, H, P, N)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, L, H))))).requires_grad_()
    A = torch.from_numpy(-np.exp(0.3 * rng.standard_normal(H))).requires_grad_()
    fn = lambda *a: SS.ssd_scan(*a[:5], chunk=chunk, initial_state=a[5])
    assert torch.autograd.gradcheck(fn, (x, dt, A, Bm, Cm, S0), eps=1e-6, atol=1e-6, rtol=1e-5)
