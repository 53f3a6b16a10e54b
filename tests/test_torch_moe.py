"""The port's MoE block (``models/moe.py``) on the CPU against the reference's.

The router is held to the reference's decisions exactly: from the same
normalized activations ``h`` (the reference's ``rms_norm`` output) and the
same gate weights, the port's ``route`` must pick the same experts
(``gate_idx``), rank each assignment at the same place within its expert
(``pos_in_expert``, token-major) and keep the same ones (``keep``), also
where capacity drops tokens and where probabilities tie.  The reference's
router is not a function of its own, so ``_ref_route`` repeats its lines
(``src/repro/models/moe.py:56-67``).  The whole block is then held to the
reference's ``moe_block`` for both dispatches within the bf16 tolerance of
``tests/test_kernels.py`` (atol = rtol = 2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import moe as RM
from repro.models.layers import rms_norm as ref_rms_norm
from repro_torch.configs import get_arch
from repro_torch.models import moe as M

TOL = 2e-2
ARCH = "llama4-scout-17b-a16e"


def _cfgs(K, E=4):
    """The reduced scout (d 64, E experts of d_ff 128) with top-``K``, in
    both packages."""
    out = []
    for cfg in (ref_arch(ARCH).with_reduced(), get_arch(ARCH).with_reduced()):
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=K, n_experts=E)))
    return out


def _params(cfg, seed):
    """Gate and expert weights large enough that an expert's output is of
    order 1, so a token sent elsewhere or dropped shows beyond the tolerance."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(pd.shape).astype(np.float32) * (0.3 if k == "w_gate" else 0.15)
                + (1.0 if pd.init == "ones" else 0.0)).astype(np.float32)
            for k, pd in RM.moe_defs(cfg).items()}


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _ref_route(h, w_gate, K, C):
    """The reference's routing lines, as ``moe_block`` runs them."""
    B, S, _ = h.shape
    E = w_gate.shape[-1]
    logits = jnp.einsum("bsd,de->bse", h.astype(jnp.float32), w_gate.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(B, S * K, E)
    ranks = jnp.cumsum(flat, axis=1) - flat
    pos_in_expert = (ranks * flat).sum(-1).reshape(B, S, K)
    return gate_vals, gate_idx, pos_in_expert, pos_in_expert < C


def _both_routes(K, cf, seed, w_gate=None, B=2, S=48):
    rcfg, cfg = _cfgs(K)
    p = _params(rcfg, seed)
    if w_gate is not None:
        p["w_gate"] = w_gate
    x = jnp.asarray(_x(rcfg, B, S, seed + 1), jnp.bfloat16)
    h = ref_rms_norm(x, jnp.asarray(p["ln"]), rcfg.rms_eps)
    C = M.capacity(cfg, S, cf)
    assert C == max(K, int(S * K * (cf or cfg.moe.capacity_factor) / cfg.moe.n_experts))
    want = [np.asarray(a) for a in _ref_route(h, jnp.asarray(p["w_gate"]), K, C)]
    th = torch.from_numpy(np.array(h.astype(jnp.float32))).to(torch.bfloat16)
    got = [t.numpy() for t in M.route(th, torch.from_numpy(p["w_gate"]), K, C)]
    return want, got, C


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("K", [1, 2])
def test_router_decisions_equal_the_reference(K, cf):
    """On the reference's own ``h``: the same experts, ranks and drops."""
    (wv, wi, wp, wk), (gv, gi, gp, gk), C = _both_routes(K, cf, seed=10 * K)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)
    if cf == 0.5:
        assert not wk.all(), "capacity 0.5 must drop tokens"
        # what is dropped comes last in token-major order within its expert
        for b in range(wi.shape[0]):
            for e in range(4):
                kept = wk[b][wi[b] == e]
                assert (np.sort(kept)[::-1] == kept).all()


@pytest.mark.parametrize("K", [1, 2])
def test_router_breaks_ties_toward_the_lower_expert_as_top_k_does(K):
    """Experts 1 and 3 get the same gate column, so every token's
    probabilities tie between them: the lower index comes first, as in
    ``jax.lax.top_k``."""
    rcfg, _ = _cfgs(K)
    w = _params(rcfg, 5)["w_gate"]
    w[:, 3] = w[:, 1]
    w[:, 1] += 0.5  # experts 1 and 3 lead, tied
    w[:, 3] += 0.5
    (_, wi, wp, wk), (_, gi, gp, gk), _ = _both_routes(K, None, seed=5, w_gate=w)
    assert ((wi == 1) | (wi == 3)).any()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gk, wk)
    if K == 2:
        assert (wi[..., 0] < wi[..., 1])[(wi[..., 0] == 1) & (wi[..., 1] == 3)].all()


@pytest.mark.parametrize("cf", [None, 0.5, 2.0])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_block_matches_reference(dispatch, K, cf):
    rcfg, cfg = _cfgs(K)
    p = _params(rcfg, 20 + K)
    x = _x(rcfg, 2, 40, 21)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = RM.moe_block({k: jnp.asarray(v) for k, v in p.items()}, jx, rcfg,
                        capacity_factor=cf, dispatch=dispatch)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    got = M.moe_block({k: torch.from_numpy(v) for k, v in p.items()}, tx, cfg,
                      capacity_factor=cf, dispatch=dispatch)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL, rtol=TOL)
    # the experts' share, apart from the residual, within the same tolerance
    np.testing.assert_allclose((got.float() - tx.float()).numpy(),
                               np.asarray(want.astype(jnp.float32) - jx.astype(jnp.float32)),
                               atol=TOL, rtol=TOL)


def test_both_dispatches_agree_and_a_dropped_token_gets_nothing():
    """The gather and einsum dispatches compute the same function; a token
    with every assignment dropped leaves the block as it came in."""
    _, cfg = _cfgs(1)
    p = {k: torch.from_numpy(v) for k, v in _params(cfg, 30).items()}
    x = torch.from_numpy(_x(cfg, 2, 64, 31)).to(torch.bfloat16)
    a = M.moe_block(p, x, cfg, capacity_factor=0.25, dispatch="gather")
    b = M.moe_block(p, x, cfg, capacity_factor=0.25, dispatch="einsum")
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=TOL, rtol=TOL)
    h = M.rms_norm(x, p["ln"], cfg.rms_eps)
    _, _, _, keep = M.route(h, p["w_gate"], 1, M.capacity(cfg, 64, 0.25))
    dropped = ~keep.any(-1)
    assert dropped.any()
    assert torch.equal(a[dropped], x[dropped]) and torch.equal(b[dropped], x[dropped])


def test_unknown_dispatch_raises():
    _, cfg = _cfgs(1)
    p = {k: torch.from_numpy(v) for k, v in _params(cfg, 0).items()}
    with pytest.raises(ValueError, match="dispatch"):
        M.moe_block(p, torch.zeros((1, 4, cfg.d_model)), cfg, dispatch="scatter")
