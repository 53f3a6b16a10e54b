"""The port's encoder-decoder (whisper-tiny) on the CPU against the reference's.

The reduced whisper-tiny (2 + 2 layers, d 64, 24 frames) is built by the
reference's ``Model.init`` and carried to the port with
``params_from_reference``; frames and tokens come from numpy seeds.  The
port's plain path on the host is held to the reference's: ``encode``,
``forward_step``, ``Model.loss``, ``encdec_decode_step`` against zero
cross-KV (what ``greedy_generate`` decodes against in both packages) and
against cross-KV from ``_enc_kv`` of the encoder's states, and
``greedy_generate``.  Both compute in bf16: atol = rtol = 2e-2.  Full-size
checks use parameter definitions only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import build_model as ref_build
from repro.models import encdec as RE
from repro.models.layers import PD as RefPD
from repro.serve.decode import greedy_generate as ref_greedy
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.models import build_model
from repro_torch.models import encdec as E
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import greedy_generate, init_caches

ARCH = "whisper-tiny"
TOL = 2e-2


def _ref_defs(tree, prefix=""):
    """``{path: shape}`` of a reference ``PD`` tree, paths as ``tree_leaves``'."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out.update({path: tuple(v.shape)} if isinstance(v, RefPD) else _ref_defs(v, path))
    return out


def _pair(seed=0):
    rm = ref_build(ref_arch(ARCH).with_reduced())
    rp = rm.init(jax.random.PRNGKey(seed))
    pm = build_model(get_arch(ARCH).with_reduced())
    pp = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rm, rp, pm, pp


def _frames(cfg, B, seed):
    """Seeded frames as bf16 in both packages (the same bits)."""
    a = np.random.default_rng(seed).standard_normal((B, cfg.encoder.n_frames, cfg.d_model),
                                                    dtype=np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(2, vocab, shape).astype(np.int32)


def _close(got, want, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("reduced", [True, False])
def test_param_defs_match_reference(reduced):
    rcfg, cfg = ref_arch(ARCH), get_arch(ARCH)
    if reduced:
        rcfg, cfg = rcfg.with_reduced(), cfg.with_reduced()
    want = _ref_defs(RE.encdec_param_defs(rcfg))
    got = {path: tuple(pd.shape) for path, pd in tree_leaves(E.encdec_param_defs(cfg))}
    assert got == want
    assert {"enc_pos", "enc_ln", "lm_head", "dec/cross/wq", "enc/self/wk"} <= set(got)


def test_n_params_equal_the_reference_at_full_size():
    n = build_model(get_arch(ARCH)).n_params()
    assert n == ref_build(ref_arch(ARCH)).n_params()
    assert 60e6 <= n <= 63e6


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_encoder_and_vision_configs_are_the_references(name):
    for cfg, ref in ((ARCHS[name], REF_ARCHS[name]),
                     (ARCHS[name].with_reduced(), REF_ARCHS[name].with_reduced())):
        for field in ("encoder", "vision"):
            got, want = getattr(cfg, field), getattr(ref, field)
            assert (got is None) == (want is None), (name, field)
            if got is not None:
                assert vars(got) == vars(want), (name, field)


def test_params_carry_leaf_for_leaf():
    rm, rp, pm, pp = _pair()
    ref_leaves = {"/".join(str(k.key) for k in path): leaf
                  for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    own = dict(tree_leaves(pm.init(0, device="cpu")))
    carried = dict(tree_leaves(pp))
    assert set(ref_leaves) == set(own) == set(carried)
    for key, leaf in ref_leaves.items():
        assert tuple(carried[key].shape) == tuple(leaf.shape) == tuple(own[key].shape), key
        np.testing.assert_array_equal(carried[key].numpy(), np.asarray(leaf))


def test_encode_matches_reference():
    rm, rp, pm, pp = _pair(seed=1)
    jf, tf = _frames(rm.cfg, 2, seed=2)
    want = RE.encode(rp, jf, rm.cfg)
    got = E.encode(pp, tf, pm.cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    _close(got, want, "encoder states")


def test_forward_step_and_loss_match_reference():
    rm, rp, pm, pp = _pair(seed=3)
    jf, tf = _frames(rm.cfg, 2, seed=4)
    toks = _tokens(rm.cfg.vocab, (2, 17), seed=5)
    rbatch = {"frames": jf, "tokens": jnp.asarray(toks)}
    batch = {"frames": tf, "tokens": torch.from_numpy(toks)}
    want = rm.forward_step(rp, rbatch)
    got = pm.forward_step(pp, batch)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 16, rm.cfg.vocab)
    _close(got, want, "forward logits")
    loss = pm.loss(pp, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(rm.loss(rp, rbatch)), atol=TOL, rtol=TOL)


def test_init_caches_are_the_reference_cache_shapes():
    cfg = get_arch(ARCH).with_reduced()
    caches = init_caches(build_model(cfg), 3, 10, device="cpu")
    want = RE.encdec_cache_shapes(ref_arch(ARCH).with_reduced(), 3, 10)
    got = dict(tree_leaves(caches))
    for path, sds in jax.tree_util.tree_flatten_with_path(want)[0]:
        t = got.pop("/".join(k.key for k in path))
        assert tuple(t.shape) == tuple(sds.shape) and t.dtype == torch.bfloat16
        assert not t.any()
    assert not got


def _ref_cross_kv(rp, jf, rcfg):
    """Cross-KV of every decoder layer from the reference encoder's states,
    stacked as the caches hold them."""
    enc = RE.encode(rp, jf, rcfg)
    ks, vs = [], []
    for i in range(rcfg.n_layers):
        lp = jax.tree_util.tree_map(lambda t: t[i], rp["dec"])
        k, v = RE._enc_kv(lp["cross"], enc, rcfg)
        ks.append(k)
        vs.append(v)
    return jnp.stack(ks), jnp.stack(vs)


@pytest.mark.parametrize("cross", ["zero", "encoder"])
def test_decode_step_matches_reference(cross):
    rm, rp, pm, pp = _pair(seed=6)
    B, S = 2, 12
    toks = _tokens(rm.cfg.vocab, (B, S), seed=7)
    rcaches = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     RE.encdec_cache_shapes(rm.cfg, B, S))
    caches = init_caches(pm, B, S, device="cpu")
    if cross == "encoder":
        jf, tf = _frames(rm.cfg, B, seed=8)
        rk, rv = _ref_cross_kv(rp, jf, rm.cfg)
        rcaches["dec"]["cross_k"], rcaches["dec"]["cross_v"] = rk, rv
        # the port's cross-KV from its own encoder, against the reference's
        enc = E.encode(pp, tf, pm.cfg)
        for i in range(pm.cfg.n_layers):
            lp = {k: t[i] for k, t in pp["dec"]["cross"].items()}
            k, v = E._enc_kv(lp, enc, pm.cfg)
            _close(k, rk[i], f"cross k of layer {i}")
            _close(v, rv[i], f"cross v of layer {i}")
            caches["dec"]["cross_k"][i].copy_(k)
            caches["dec"]["cross_v"][i].copy_(v)
        full = pm.forward_step(pp, {"frames": tf, "tokens": torch.from_numpy(
            np.concatenate([toks, toks[:, :1]], axis=1))}).float().numpy()
    step = jax.jit(lambda p, c, t, pos: rm.decode_step(p, c, t, pos))
    for t in range(S):
        want, rcaches = step(rp, rcaches, jnp.asarray(toks[:, t]), jnp.asarray(t))
        got, caches = pm.decode_step(pp, caches, torch.from_numpy(toks[:, t]), t)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, rm.cfg.vocab)
        _close(got, want, f"decode logits at {t} against {cross} cross-KV")
        if cross == "encoder":
            # decode against the forward: what the card's gate relies on
            np.testing.assert_allclose(got.numpy(), full[:, t], atol=0.15, rtol=0.15)
    for path, leaf in jax.tree_util.tree_flatten_with_path(rcaches)[0]:
        node = caches
        for k in path:
            node = node[k.key]
        _close(node, leaf, f"cache {path}")


def test_greedy_generate_matches_reference():
    """Against zero cross-KV in both packages.  Along the reference's
    tokens, the port's decode logits are within the tolerance of the
    reference's everywhere, and its argmax is the reference's token wherever
    the reference's top two logits are further apart than the tolerance;
    ``greedy_generate``'s tokens are the reference's up to the first
    near-tie (reported)."""
    rm, rp, pm, pp = _pair(seed=9)
    B, S0, N = 2, 10, 10
    prompt = _tokens(rm.cfg.vocab, (B, S0), seed=10)
    want = np.asarray(ref_greedy(rm, rp, jnp.asarray(prompt), max_new_tokens=N))
    got = greedy_generate(pm, pp, torch.from_numpy(prompt), max_new_tokens=N).numpy()
    assert got.shape == want.shape == (B, N)

    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    rcaches = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     RE.encdec_cache_shapes(rm.cfg, B, seq.shape[1]))
    caches = init_caches(pm, B, seq.shape[1], device="cpu")
    step = jax.jit(lambda p, c, t, pos: rm.decode_step(p, c, t, pos))
    ref_logits, port_logits = [], []
    for t in range(seq.shape[1]):
        lg, rcaches = step(rp, rcaches, jnp.asarray(seq[:, t]), jnp.asarray(t))
        ref_logits.append(np.asarray(lg))
        lg, caches = pm.decode_step(pp, caches, torch.from_numpy(seq[:, t]), t)
        port_logits.append(lg.numpy())
    ref_logits = np.stack(ref_logits, axis=1)[:, S0 - 1:]
    port_logits = np.stack(port_logits, axis=1)[:, S0 - 1:]
    np.testing.assert_allclose(port_logits, ref_logits, atol=TOL, rtol=TOL)
    assert (ref_logits.argmax(-1) == want).all()
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > TOL + TOL * np.abs(top2[..., 1])
    print(f"{ARCH}: {int((~decisive).sum())} near-ties of {decisive.size} generated positions")
    assert decisive.sum() >= decisive.size // 2
    assert (port_logits.argmax(-1) == want)[decisive].all()
    for b in range(B):
        ties = np.nonzero(~decisive[b])[0]
        first_tie = ties[0] if len(ties) else N
        assert (got[b, :first_tie] == want[b, :first_tie]).all()
