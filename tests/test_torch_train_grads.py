"""Gradients of every family's ``Model.loss`` in the port against
``jax.grad`` of the reference's, on the CPU.

Reduced configs (``with_reduced()``) of the dense, ssm, audio and VLM
families: the reference builds the parameters, ``params_from_reference``
carries them; tokens (and frames, patch embeddings) come from numpy seeds.
Both sides cast every fp32 parameter with two or more dimensions to bf16 at
step entry, as both ``make_train_step``s do: the port through
``train.loss_and_grads`` (its default ``attn_impl="auto"``, which on the
host runs the flash attention and RMSNorm autograd Functions with the plain
backward versions), the reference through ``jax.value_and_grad`` of its
``Model.loss`` (``attn_impl="reference"``, ``remat=True``).  The loss is
held within 0.02 + 0.02 |loss| and every leaf's gradient within 2e-2
relative L2 (bf16 compute on both sides).  ``remat=True`` and
``remat=False`` give the same gradients in the port within 1e-6.  The MoE
and hybrid families are in ``tests/test_torch_train_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build_model as ref_build
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves
from repro_torch.train import loss_and_grads

GRAD_TOL = 2e-2   # relative L2 per leaf
REMAT_TOL = 1e-6


def carried(arch, seed=0):
    """(reference model, reference params, the port's config, carried params)."""
    rm = ref_build(ref_arch(arch).with_reduced())
    rp = rm.init(jax.random.PRNGKey(seed))
    return rm, rp, get_arch(arch).with_reduced(), params_from_reference(
        jax.tree_util.tree_map(np.asarray, rp), device="cpu")


def batches(cfg, seed=1, B=2, S=32):
    """The same batch for both packages: tokens, and frames or patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (B, S + 1)).astype(np.int32)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    extra = {"audio": ("frames", (B, cfg.encoder.n_frames, cfg.d_model)) if cfg.encoder else None,
             "vlm": ("patch_embeds", (B, cfg.vision.n_patches, cfg.vision.d_vision))
             if cfg.vision else None}.get(cfg.family)
    if extra is not None:
        name, shape = extra
        a = rng.standard_normal(shape, dtype=np.float32)
        rb[name], pb[name] = jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return rb, pb


def ref_loss_and_grads(rm, rp, batch):
    def f(p, b):
        cp = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
        return rm.loss(cp, b)

    loss, grads = jax.value_and_grad(f)(rp, batch)
    return float(loss), dict(tree_leaves(jax.tree_util.tree_map(np.asarray, grads)))


def rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "whisper-tiny", "internvl2-2b"])
def test_loss_gradients_match_the_reference(arch):
    rm, rp, cfg, pp = carried(arch)
    rb, pb = batches(cfg)
    want_loss, want = ref_loss_and_grads(rm, rp, rb)
    loss, grads = loss_and_grads(build_model(cfg), pp, pb)
    assert abs(float(loss) - want_loss) <= 0.02 + 0.02 * abs(want_loss)
    got = dict(tree_leaves(grads))
    assert sorted(got) == sorted(want)
    misses = {path: rel_l2(g, want[path]) for path, g in got.items() if rel_l2(g, want[path]) > GRAD_TOL}
    assert not misses, misses
    # remat off: the same gradients (the recompute runs the same ops)
    _, plain = loss_and_grads(build_model(cfg, remat=False), pp, pb)
    for path, g in tree_leaves(plain):
        torch.testing.assert_close(g, got[path], atol=REMAT_TOL, rtol=REMAT_TOL)
