"""The plain mirror of the bf16 flash backward kernel against the reference,
on the CPU.

``ref.flash_attention_bwd_tc_reference`` repeats the arithmetic of
``csrc/flash_attention_bwd_sm90.cu`` (base-2 exponent, P and dS split into
bf16 hi + lo, its tile order); ``tests/test_torch_bwd_cuda.py`` holds the
kernel to it on the card.  Here it is held to the reference's custom VJP
(``_flash_bwd_impl``) on the same bf16 inputs, the forward's bf16 output
and its lse, made from numpy seeds, over the kernel tests' ``CASES`` (every
mask, ``q_offset``, S != T, T = 1500, D = 16 ... 128), at bf16's 2e-2 (the
tolerance of ``tests/test_kernels.py``); and to the port's plain backward,
from which hi + lo moves at most 1 in 100 bf16 gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro_torch.kernels import ref
from test_torch_bwd_cuda import CASES

TOL = 2e-2


def _inputs(B, S, T, H, KV, D, masks):
    """bf16 q, k, v, dO from numpy seeds, and the reference forward's bf16
    output and fp32 lse on them: jax arrays and torch tensors of the same
    values."""
    rng = np.random.default_rng(S + T + D)
    arrays = [rng.standard_normal(s, dtype=np.float32) * 0.5
              for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D), (B, S, H, D))]
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    jo, jlse = RK._flash_fwd_impl(jq, jk, jv, masks.get("causal", True), masks.get("window"),
                                  masks.get("chunk"), 512, 512, masks.get("q_offset", 0))
    torch_of = [torch.from_numpy(np.array(a, np.float32)) for a in (jq, jk, jv, jo, jlse, jg)]
    q, k, v, o, lse, g = (t if i == 4 else t.to(torch.bfloat16) for i, t in enumerate(torch_of))
    return (jq, jk, jv, jo, jlse, jg), (q, k, v, o, lse, g)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_tc_mirror_matches_the_references_custom_vjp(case):
    name, B, S, T, H, KV, D, masks = case
    (jq, jk, jv, jo, jlse, jg), args = _inputs(B, S, T, H, KV, D, masks)
    want = RK._flash_bwd_impl(jq, jk, jv, jo, jlse, jg, masks.get("causal", True), masks.get("window"),
                              masks.get("chunk"), 512, 512, masks.get("q_offset", 0))
    got = ref.flash_attention_bwd_tc_reference(*args, **masks)
    for what, a, b, like in zip(("dq", "dk", "dv"), got, want, args[:3]):
        assert a.dtype == torch.bfloat16 and a.shape == like.shape
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=TOL, rtol=TOL,
                                   err_msg=f"{name}: {what}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_tc_mirror_multiplies_p_and_ds_as_the_plain_version_does(case):
    """P and dS enter their products as bf16 hi + lo, close to the fp32 of
    the plain backward: at most 1 in 100 bf16 gradients differ from its."""
    name, B, S, T, H, KV, D, masks = case
    _, args = _inputs(B, S, T, H, KV, D, masks)
    got = ref.flash_attention_bwd_tc_reference(*args, **masks)
    plain = ref.flash_attention_bwd_reference(*args, **masks)
    for what, a, b in zip(("dq", "dk", "dv"), got, plain):
        assert float((a != b).float().mean()) <= 0.01, f"{name}: {what}"
