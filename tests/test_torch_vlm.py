"""The port's VLM (internvl2-2b) on the CPU against the reference's.

The reduced internvl2-2b (2 layers, d 64, 16 patches of d_vision 64) is
built by the reference's ``Model.init`` and carried to the port with
``params_from_reference``; patch embeddings and tokens come from numpy
seeds.  The port's plain path on the host is held to the reference's:
``lm_forward`` with ``prefix_embeds`` (the causal mask and the positions run
over the patches too), ``forward_step`` with ``patch_embeds`` (all patch and
token positions), ``vlm_loss`` / ``Model.loss`` (text positions only) and
the text-only ``greedy_generate``.  Both compute in bf16: atol = rtol =
2e-2.  Full-size checks use parameter definitions only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.models import vlm as RV
from repro.models.layers import PD as RefPD
from repro.serve.decode import greedy_generate as ref_greedy
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import greedy_generate, init_caches

ARCH = "internvl2-2b"
TOL = 2e-2


def _ref_defs(tree, prefix=""):
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


def _bf16(shape, seed, scale=1.0):
    """Seeded values as bf16 in both packages (the same bits)."""
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _patches(cfg, B, seed):
    return _bf16((B, cfg.vision.n_patches, cfg.vision.d_vision), seed)


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
    want = _ref_defs(RV.vlm_param_defs(rcfg))
    got = {path: tuple(pd.shape) for path, pd in tree_leaves(V.vlm_param_defs(cfg))}
    assert got == want
    assert got["vision_proj"] == (cfg.vision.d_vision, cfg.d_model)


def test_n_params_equal_the_reference_at_full_size():
    n = build_model(get_arch(ARCH)).n_params()
    assert n == ref_build(ref_arch(ARCH)).n_params()
    assert 1.8e9 <= n <= 2.0e9


def test_params_carry_leaf_for_leaf():
    rm, rp, pm, pp = _pair()
    ref_leaves = {"/".join(str(k.key) for k in path): leaf
                  for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    carried = dict(tree_leaves(pp))
    assert set(ref_leaves) == set(carried) == {p for p, _ in tree_leaves(pm.param_defs())}
    for key, leaf in ref_leaves.items():
        np.testing.assert_array_equal(carried[key].numpy(), np.asarray(leaf))


def test_lm_forward_with_prefix_matches_reference():
    rm, rp, pm, pp = _pair(seed=1)
    jpre, tpre = _bf16((2, 5, rm.cfg.d_model), seed=2)
    toks = _tokens(rm.cfg.vocab, (2, 11), seed=3)
    want = RT.lm_forward(rp, jnp.asarray(toks), rm.cfg, prefix_embeds=jpre)
    got = T.lm_forward(pp, torch.from_numpy(toks), pm.cfg, prefix_embeds=tpre)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 16, rm.cfg.vocab)
    _close(got, want, "logits with a prefix")
    # causal across the prefix: the prefix positions' logits do not see the tokens
    alone = T.lm_forward(pp, torch.from_numpy(toks[:, :1]), pm.cfg, prefix_embeds=tpre)
    torch.testing.assert_close(alone[:, :5], got[:, :5], atol=0, rtol=0)


def test_forward_step_and_loss_match_reference():
    rm, rp, pm, pp = _pair(seed=4)
    jp, tp = _patches(rm.cfg, 2, seed=5)
    toks = _tokens(rm.cfg.vocab, (2, 13), seed=6)
    rbatch = {"tokens": jnp.asarray(toks), "patch_embeds": jp}
    batch = {"tokens": torch.from_numpy(toks), "patch_embeds": tp}
    want = rm.forward_step(rp, rbatch)
    got = pm.forward_step(pp, batch)
    Sp = rm.cfg.vision.n_patches
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, Sp + 12, rm.cfg.vocab)
    _close(got, want, "forward logits over patches and tokens")
    loss = pm.loss(pp, batch)
    want_loss = float(rm.loss(rp, rbatch))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), want_loss, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(V.vlm_loss(pp, batch, pm.cfg)),
                               float(RV.vlm_loss(rp, rbatch, rm.cfg)), atol=TOL, rtol=TOL)
    # the loss is over the text positions only: the forward's last 12
    lg = got[:, Sp:].float()
    manual = (torch.logsumexp(lg, -1) - torch.gather(lg, -1, batch["tokens"][:, 1:, None].long())[..., 0])
    np.testing.assert_allclose(float(manual.mean()), float(loss), rtol=1e-5)


def test_greedy_generate_matches_reference():
    """Text-only decoding, as in the reference.  Along the reference's
    tokens, the port's decode logits are within the tolerance of the
    reference's everywhere, and its argmax is the reference's token wherever
    the reference's top two logits are further apart than the tolerance;
    ``greedy_generate``'s tokens are the reference's up to the first
    near-tie (reported)."""
    rm, rp, pm, pp = _pair(seed=7)
    B, S0, N = 2, 10, 10
    prompt = _tokens(rm.cfg.vocab, (B, S0), seed=8)
    want = np.asarray(ref_greedy(rm, rp, jnp.asarray(prompt), max_new_tokens=N))
    got = greedy_generate(pm, pp, torch.from_numpy(prompt), max_new_tokens=N).numpy()
    assert got.shape == want.shape == (B, N)

    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    rcaches = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     RT.lm_cache_shapes(rm.cfg, B, seq.shape[1]))
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
    assert (port_logits.argmax(-1) == want)[decisive].all()
    for b in range(B):
        ties = np.nonzero(~decisive[b])[0]
        first_tie = ties[0] if len(ties) else N
        assert (got[b, :first_tie] == want[b, :first_tie]).all()
