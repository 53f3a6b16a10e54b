"""The MoE (llama4-scout) and hybrid (jamba) families' gradients in fp32
compute against the reference's, on the CPU: why, and the tolerances, are
in ``tests/test_torch_train_moe.py``.  ``COMPUTE_DTYPE`` is patched in both
packages for the test's duration; no parameter is cast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as RT
import repro_torch.models.transformer as PT
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves
from test_torch_train_grads import carried, batches, rel_l2
ARCHS = ["llama4-scout-17b-a16e", "jamba-1.5-large-398b"]

FP32_TOL = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_gradients_match_the_reference(arch, monkeypatch):
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    rm, rp, cfg, pp = carried(arch)
    rb, pb = batches(cfg)
    want_loss, rg = jax.value_and_grad(rm.loss)(rp, rb)
    want = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, rg)))
    leaves = [t.requires_grad_() for _, t in tree_leaves(pp)]
    loss = build_model(cfg).loss(pp, pb)
    got = dict(zip([p for p, _ in tree_leaves(pp)], torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    top1 = cfg.moe.top_k == 1
    misses = {}
    for path, g in got.items():
        if top1 and path.endswith("w_gate"):
            assert float(g.abs().max()) <= 1e-8 and float(np.abs(want[path]).max()) <= 1e-8, path
        elif rel_l2(g, want[path]) > FP32_TOL:
            misses[path] = rel_l2(g, want[path])
    assert not misses, misses
