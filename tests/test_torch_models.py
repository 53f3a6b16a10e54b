"""The port's dense, Mamba-2, MoE and hybrid LMs on the CPU against the
reference's.

For the reduced llama3-8b, gemma3-27b, glm4-9b, command-r-plus-104b,
mamba2-2.7b, llama4-scout, llama4-maverick and jamba, the reference's ``Model.init`` parameters are carried to the
port with ``params_from_reference``; then the port's forward logits (plain
path on the host) are held to the reference's ``attn_impl="reference"``
forward, its decode-step logits to the reference's over 16 positions, and
``Model.loss`` to the reference's ``lm_loss``.
Both compute in bf16: atol = rtol = 2e-2.  Parameter counts of the full-size
configs must equal the reference's.  The mamba block's pieces whose
semantics are easy to miss (the causal conv, the softplus of ``dt``, the
decode step's conv buffer) are held to ``repro.models.ssm`` on their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build_model as ref_build
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.models import build_model
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves

DENSE = ["llama3-8b", "gemma3-27b", "glm4-9b", "command-r-plus-104b"]
MOE = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
SERVED = DENSE + ["mamba2-2.7b"] + MOE
TOL = 2e-2  # bf16 activations and logits in both


def _pair(arch, seed=0):
    """(reference model, reference params, port model, port params)."""
    rm = ref_build(ref_arch(arch).with_reduced())
    rp = rm.init(jax.random.PRNGKey(seed))
    pm = build_model(get_arch(arch).with_reduced())
    pp = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rm, rp, pm, pp


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(2, vocab, shape).astype(np.int32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("arch", SERVED)
def test_params_carry_leaf_for_leaf(arch):
    rm, rp, pm, pp = _pair(arch)
    ref_leaves = {"/".join(str(k.key) for k in path): leaf
                  for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    own = dict(tree_leaves(pm.init(0, device="cpu")))
    carried = dict(tree_leaves(pp))
    assert set(ref_leaves) == set(own) == set(carried)
    for key, leaf in ref_leaves.items():
        assert tuple(carried[key].shape) == tuple(leaf.shape) == tuple(own[key].shape), key
        assert carried[key].dtype == own[key].dtype == torch.float32, key
        np.testing.assert_array_equal(carried[key].numpy(), np.asarray(leaf))
    assert "scan" in pp and all(t.shape[0] == RT._segments(rm.cfg)[1]
                                for _, t in tree_leaves(pp["scan"]))


@pytest.mark.parametrize("arch", SERVED)
def test_forward_matches_reference(arch):
    rm, rp, pm, pp = _pair(arch)
    toks = _tokens(rm.cfg.vocab, (2, 33), seed=1)
    want = rm.forward_step(rp, {"tokens": jnp.asarray(toks)})
    got = pm.forward_step(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    _close(got.float().numpy(), want, f"{arch} forward logits")


@pytest.mark.parametrize("arch", SERVED)
def test_decode_step_matches_reference(arch):
    rm, rp, pm, pp = _pair(arch, seed=1)
    B, S = 2, 16
    toks = _tokens(rm.cfg.vocab, (B, S), seed=2)
    rcaches = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     RT.lm_cache_shapes(rm.cfg, B, S))
    caches = T.init_cache_tree(pm.cfg, B, S, "cpu")
    step = jax.jit(lambda p, c, t, pos: rm.decode_step(p, c, t, pos))
    full = pm.forward(pp, torch.from_numpy(toks)).float().numpy()
    for t in range(S):
        want, rcaches = step(rp, rcaches, jnp.asarray(toks[:, t]), jnp.asarray(t))
        got, caches = pm.decode_step(pp, caches, torch.from_numpy(toks[:, t]), t)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, rm.cfg.vocab)
        _close(got.numpy(), want, f"{arch} decode logits at {t}")
        # and the port's own decode against its forward, as the reference's smoke test does
        np.testing.assert_allclose(got.numpy(), full[:, t], atol=0.15, rtol=0.15)
    for path, leaf in jax.tree_util.tree_flatten_with_path(rcaches)[0]:
        node = caches
        for k in path:
            node = node[k.key]
        _close(node.float().numpy(), leaf, f"{arch} cache {path}")


@pytest.mark.parametrize("pos", [16, 40, -3, -20])
def test_decode_clamps_an_out_of_range_pos_as_the_reference_does(pos):
    """``jax.lax.dynamic_update_slice`` counts a negative start index from
    the end and clamps it so the update fits: a ``pos`` past the cache
    writes its last slot, -3 the slot 3 from the end, -20 the first.  The
    port writes the same slot instead of raising."""
    rm, rp, pm, pp = _pair("llama3-8b", seed=3)
    B, L = 2, 16
    rng = np.random.default_rng(4)
    ref_caches = {"scan": {"l0": {n: rng.standard_normal((2, B, L, 2, 16)).astype(np.float32)
                                  for n in ("k", "v")}}}
    rcaches = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), ref_caches)
    # bf16 leaves carry over bit for bit
    caches = params_from_reference(jax.tree_util.tree_map(np.asarray, rcaches), device="cpu")
    assert caches["scan"]["l0"]["k"].dtype == torch.bfloat16
    assert np.array_equal(caches["scan"]["l0"]["k"].float().numpy(),
                          np.asarray(rcaches["scan"]["l0"]["k"], np.float32))
    tok = _tokens(rm.cfg.vocab, (B,), seed=5)
    want, rnew = rm.decode_step(rp, rcaches, jnp.asarray(tok), jnp.asarray(pos))
    got, new = pm.decode_step(pp, caches, torch.from_numpy(tok), pos)
    _close(got.numpy(), want, "logits at a clamped pos")
    slot = min(max(pos + L if pos < 0 else pos, 0), L - 1)
    for n in ("k", "v"):
        r = np.asarray(rnew["scan"]["l0"][n], np.float32)
        g = new["scan"]["l0"][n].float().numpy()
        old = np.asarray(rcaches["scan"]["l0"][n], np.float32)
        changed = np.nonzero((r != old).any(axis=(0, 1, 3, 4)))[0]
        assert list(changed) == [slot]  # the reference wrote only the clamped slot
        _close(g, r, f"cache {n} after a write at pos {pos}")
        assert np.array_equal(np.delete(g, slot, axis=2), np.delete(old, slot, axis=2))


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-27b", "mamba2-2.7b"])
def test_prefill_matches_reference(arch):
    """``lm_prefill`` (decode-based, fills the caches) against the
    reference's: the last position's logits and the caches."""
    rm, rp, pm, pp = _pair(arch, seed=6)
    toks = _tokens(rm.cfg.vocab, (2, 12), seed=7)
    want, rcaches = RT.lm_prefill(rp, jnp.asarray(toks), 16, rm.cfg)
    got, caches = T.lm_prefill(pp, torch.from_numpy(toks), 16, pm.cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, rm.cfg.vocab)
    _close(got.numpy(), want, f"{arch} prefill logits")
    for path, leaf in jax.tree_util.tree_flatten_with_path(rcaches)[0]:
        node = caches
        for k in path:
            node = node[k.key]
        _close(node.float().numpy(), leaf, f"{arch} prefill cache {path}")


def test_n_params_equal_the_reference_at_full_size():
    for arch in SERVED:
        assert build_model(get_arch(arch)).n_params() == ref_build(ref_arch(arch)).n_params(), arch
        assert build_model(get_arch(arch)).n_active_params() == ref_build(ref_arch(arch)).n_active_params()
    assert 8.0e9 <= build_model(get_arch("llama3-8b")).n_params() <= 8.5e9
    assert 25e9 <= build_model(get_arch("gemma3-27b")).n_params() <= 30e9
    assert 95e9 <= build_model(get_arch("command-r-plus-104b")).n_params() <= 112e9
    assert 2.5e9 <= build_model(get_arch("mamba2-2.7b")).n_params() <= 3.0e9
    assert 100e9 <= build_model(get_arch("llama4-scout-17b-a16e")).n_params() <= 115e9
    assert build_model(get_arch("llama4-scout-17b-a16e")).n_active_params() < 20e9


def test_silu_is_the_references_bit_for_bit_in_bf16():
    """The port computes ``jax.nn.silu`` op by op, so in the model's bf16
    its rounding is the reference's exactly (a fused ``F.silu`` rounds
    once, and differs in the last bit)."""
    from repro_torch.models.layers import silu

    x = np.random.default_rng(9).standard_normal((64, 256)).astype(np.float32) * 3
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = silu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_configs_are_the_reference_configs():
    from repro.configs.registry import ARCHS as REF_ARCHS

    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        ref = REF_ARCHS[name]
        for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                      "vocab", "pattern", "window", "chunk", "rope_theta", "rms_eps",
                      "tie_embeddings", "scan_period", "sub_quadratic"):
            assert getattr(cfg, field) == getattr(ref, field), (name, field)
            assert getattr(cfg.with_reduced(), field) == getattr(ref.with_reduced(), field), (name, field)


def test_build_model_builds_every_config():
    for name, cfg in ARCHS.items():
        model = build_model(cfg)
        assert model.n_params() == ref_build(ref_arch(name)).n_params(), name
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_arch("llama3-8b"), family="speech"))


@pytest.mark.parametrize("arch", SERVED)
def test_loss_matches_reference(arch):
    """``Model.loss`` (the fp32 log-sum-exp over the forward's logits less
    the label's logit, averaged) against the reference's ``lm_loss``."""
    rm, rp, pm, pp = _pair(arch, seed=8)
    toks = _tokens(rm.cfg.vocab, (2, 33), seed=9)
    want = float(rm.loss(rp, {"tokens": jnp.asarray(toks)}))
    got = pm.loss(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, atol=TOL, rtol=TOL)
    assert pm.loss_fn()(pp, {"tokens": torch.from_numpy(toks)}) == got


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(np.array(a)).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_causal_conv_matches_reference(seed):
    """The taps summed in order, each product and add rounded in bf16, then
    the bias and the op-by-op silu: the reference's bits."""
    rng = np.random.default_rng(seed)
    jx, tx = _bf16(rng.standard_normal((2, 19, 48), dtype=np.float32))
    w = rng.standard_normal((4, 48), dtype=np.float32) * 0.3
    b = rng.standard_normal((48,), dtype=np.float32) * 0.1
    want = np.asarray(RS._causal_conv(jx, jnp.asarray(w), jnp.asarray(b), 4), np.float32)
    got = S._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b), 4)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_softplus_of_dt_matches_jax_on_both_sides_of_the_torch_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere (``F.softplus``
    switches to x above its threshold of 20); the port computes the same."""
    x = np.concatenate([np.linspace(-40, 40, 161, dtype=np.float32),
                        np.random.default_rng(3).standard_normal(200).astype(np.float32) * 8])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = S.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_decode_block_matches_reference_and_keeps_its_conv_buffer(seed):
    """One decode step of a reduced mamba block from nonzero caches: the
    output, the bf16 conv buffer (the last d_conv - 1 inputs of x, B and C
    projections, concatenated) and the fp32 state, against the reference."""
    cfg, rcfg = get_arch("mamba2-2.7b").with_reduced(), ref_arch("mamba2-2.7b").with_reduced()
    rng = np.random.default_rng(seed)
    rp = RS.mamba_defs(rcfg)
    rparams = {k: (rng.standard_normal(pd.shape, dtype=np.float32) * 0.2
                   + (1.0 if pd.init == "ones" else 0.0)).astype(np.float32)
               for k, pd in rp.items()}
    shapes = RS.mamba_cache_shape(rcfg, 2)
    conv = rng.standard_normal(shapes["conv"].shape, dtype=np.float32)
    ssm = rng.standard_normal(shapes["ssm"].shape, dtype=np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    jx, tx = _bf16(x)
    want, wc = RS.mamba_decode_block({k: jnp.asarray(v) for k, v in rparams.items()}, jx,
                                     {"conv": jnp.asarray(conv, jnp.bfloat16),
                                      "ssm": jnp.asarray(ssm)}, jnp.asarray(3), rcfg)
    assert {k: (tuple(v[0]), v[1]) for k, v in S.mamba_cache_shape(cfg, 2).items()} == {
        "conv": (tuple(shapes["conv"].shape), torch.bfloat16),
        "ssm": (tuple(shapes["ssm"].shape), torch.float32)}
    cache = {"conv": torch.from_numpy(conv).to(torch.bfloat16), "ssm": torch.from_numpy(ssm)}
    got, gc = S.mamba_decode_block({k: torch.from_numpy(v) for k, v in rparams.items()}, tx,
                                   cache, 3, cfg)
    assert gc["conv"] is cache["conv"] and gc["ssm"] is cache["ssm"]  # updated in place
    np.testing.assert_array_equal(gc["conv"].float().numpy(), np.asarray(wc["conv"], np.float32))
    # the buffer is the old one shifted by one token, the new token's projections last
    np.testing.assert_array_equal(gc["conv"][:, :-1].float().numpy(),
                                  torch.from_numpy(conv).to(torch.bfloat16)[:, 1:].float().numpy())
    np.testing.assert_allclose(gc["ssm"].numpy(), np.asarray(wc["ssm"]), atol=TOL, rtol=TOL)
    _close(got.float().numpy(), want, "mamba decode block output")
