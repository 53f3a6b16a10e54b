"""The port's ``greedy_generate`` on the CPU against the reference's, for
reduced dense models, reduced mamba2-2.7b (KV caches and SSM caches), and
reduced llama4-scout and jamba (MoE, and MoE beside mamba layers).

From the same parameters (carried with ``params_from_reference``), the
reference generates greedily; both packages then run teacher-forced along
the reference's tokens, and at every generated position the port's logits
must be within the logit tolerance (bf16: atol = rtol = 2e-2) of the
reference's, and its argmax must be the reference's token wherever the
reference's top-two gap exceeds that tolerance.  Positions under it are
near-ties, reported and not held.  The port's own ``greedy_generate`` must
then produce the reference's tokens up to the first near-tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.serve.decode import greedy_generate as ref_greedy
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import greedy_generate, init_caches

TOL = 2e-2


def _teacher_forced_ref(model, params, seq):
    B, S = seq.shape
    caches = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    RT.lm_cache_shapes(model.cfg, B, S))
    step = jax.jit(lambda p, c, t, pos: model.decode_step(p, c, t, pos))
    out = []
    for t in range(S):
        logits, caches = step(params, caches, jnp.asarray(seq[:, t]), jnp.asarray(t))
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def _teacher_forced_port(model, params, seq):
    B, S = seq.shape
    caches = init_caches(model, B, S, device="cpu")
    out = []
    for t in range(S):
        logits, caches = model.decode_step(params, caches, torch.from_numpy(seq[:, t]), t)
        out.append(logits.numpy())
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-27b", "mamba2-2.7b",
                                  "llama4-scout-17b-a16e", "jamba-1.5-large-398b"])
def test_greedy_generate_matches_reference(arch):
    rm = ref_build(ref_arch(arch).with_reduced())
    rp = rm.init(jax.random.PRNGKey(7))
    pm = build_model(get_arch(arch).with_reduced())
    pp = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    B, S0, N = 2, 12, 12
    prompt = np.random.default_rng(8).integers(2, rm.cfg.vocab, (B, S0)).astype(np.int32)
    want = np.asarray(ref_greedy(rm, rp, jnp.asarray(prompt), max_new_tokens=N))
    assert want.shape == (B, N)

    # teacher-forced along the reference's tokens: logits at positions S0-1 .. S0+N-2
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    ref_logits = _teacher_forced_ref(rm, rp, seq)[:, S0 - 1:]
    port_logits = _teacher_forced_port(pm, pp, seq)[:, S0 - 1:]
    np.testing.assert_allclose(port_logits, ref_logits, atol=TOL, rtol=TOL)
    assert (ref_logits.argmax(-1) == want).all()

    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > TOL + TOL * np.abs(top2[..., 1])
    print(f"{arch}: {int((~decisive).sum())} near-ties of {decisive.size} generated positions")
    assert decisive.sum() >= decisive.size // 2
    assert (port_logits.argmax(-1) == want)[decisive].all()

    got = greedy_generate(pm, pp, torch.from_numpy(prompt), max_new_tokens=N).numpy()
    assert got.shape == (B, N)
    for b in range(B):
        ties = np.nonzero(~decisive[b])[0]
        first_tie = ties[0] if len(ties) else N  # from there on the two may part
        assert (got[b, :first_tie] == want[b, :first_tie]).all()
