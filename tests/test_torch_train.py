"""The port's optimizer, train step, loop and fault pieces on the CPU.

One ``AdamW.update`` from the reference's params, gradients and state
(carried with ``params_from_reference`` / ``opt_state_from_reference``)
matches the reference's within 1e-6 relative, with and without int8
gradient compression, and ``_compress_decompress`` gives the reference's
int8 codes, dequantized gradients and error-feedback buffers exactly.
Then a counterpart of every case of ``tests/test_train_infra.py`` on the
port (the data-pipeline case is ``tests/test_torch_data.py``'s), with the
reference's tolerances, and the training twin ``examples/torch_train_lm.py``
at a tiny size.
"""

import importlib.util
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import AdamW as RefAdamW
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import _compress_decompress as ref_compress
from repro_torch.carry import opt_state_from_reference, params_from_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.distributed.fault import ElasticPlan, FailureInjector, StragglerMonitor
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves
from repro_torch.train import AdamW, AdamWConfig, make_train_step
from repro_torch.train.loop import fit, fit_with_restarts
from repro_torch.train.optimizer import _compress_decompress, _quantize, zero1_spec

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPT_TOL = 1e-6


def _tiny_model():
    return build_model(get_arch("llama3-8b").with_reduced())


def _batches(model, B=4, S=32, fixed=False):
    rng = np.random.default_rng(0)
    if fixed:  # one memorizable batch — loss must drop
        b = {"tokens": rng.integers(2, model.cfg.vocab, (B, S + 1)).astype(np.int32)}
        return itertools.repeat(b)

    def gen():
        while True:
            yield {"tokens": rng.integers(2, model.cfg.vocab, (B, S + 1)).astype(np.int32)}

    return gen()


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_state(compress, seed=0):
    """A reference state a few steps in, its params and fresh gradients."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 16), dtype=np.float32),
              "b": {"g": rng.standard_normal(16, dtype=np.float32),
                    "h": rng.standard_normal((4, 3, 5), dtype=np.float32)}}
    opt = RefAdamW(RefAdamWConfig(compress_grads=compress, warmup_steps=3, grad_clip=0.5))
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    for _ in range(2):  # moments and step away from zero
        g = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.standard_normal(x.shape, dtype=np.float32)), p)
        p, state, _ = opt.update(p, g, state)
    grads = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.standard_normal(x.shape, dtype=np.float32)), p)
    return opt, p, grads, state


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_the_reference(compress):
    opt, p, grads, state = _ref_state(compress)
    want_p, want_state, want_m = opt.update(p, grads, state)
    port = AdamW(AdamWConfig(compress_grads=compress, warmup_steps=3, grad_clip=0.5))
    pp = params_from_reference(_np(p), device="cpu")
    ps = opt_state_from_reference(_np(state), device="cpu")
    assert ps["step"].dtype == torch.int32 and ps["step"].dim() == 0
    got_p, got_state, got_m = port.update(pp, opt_state_from_reference(_np(grads), device="cpu"), ps)
    assert int(got_state["step"]) == int(want_state["step"])
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]), rtol=OPT_TOL)
    want = dict(tree_leaves(_np({"p": want_p, **{k: want_state[k] for k in want_state if k != "step"}})))
    got = dict(tree_leaves({"p": got_p, **{k: got_state[k] for k in got_state if k != "step"}}))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=OPT_TOL, atol=OPT_TOL * np.abs(want[path]).max(),
                                   err_msg=path)


def test_compress_decompress_is_the_references_exactly():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((6, 7), dtype=np.float32) * 3,
             "b": {"c": rng.standard_normal(11, dtype=np.float32) * 1e-3}}
    ef = {"a": rng.standard_normal((6, 7), dtype=np.float32) * 0.01,
          "b": {"c": np.zeros(11, np.float32)}}
    want_deq, want_ef = (_np(t) for t in ref_compress(*(jax.tree_util.tree_map(jnp.asarray, t)
                                                        for t in (grads, ef))))
    tg, te = (params_from_reference(t, device="cpu") for t in (grads, ef))
    deq, new_ef = _compress_decompress(tg, te)
    for (path, d), (_, e) in zip(tree_leaves(deq), tree_leaves(new_ef)):
        assert torch.equal(d, torch.from_numpy(np.array(dict(tree_leaves(want_deq))[path])))
        assert torch.equal(e, torch.from_numpy(np.array(dict(tree_leaves(want_ef))[path])))
    for (path, g), (_, e) in zip(tree_leaves(tg), tree_leaves(te)):
        q, scale, _ = _quantize(g, e)
        assert q.dtype == torch.int8
        want_q = np.round(dict(tree_leaves(want_deq))[path] / float(scale))
        np.testing.assert_array_equal(q.numpy(), want_q.astype(np.int8))


def test_loss_decreases():
    model = _tiny_model()
    res = fit(model, AdamW(AdamWConfig(zero1=False, lr=1e-3, warmup_steps=5)),
              _batches(model, fixed=True), steps=30, log_every=0, device="cpu")
    assert res.losses[-1] < res.losses[0]


@pytest.mark.parametrize("async_write", [False, True])
def test_failure_injection_and_restart(tmp_path, async_write):
    model = _tiny_model()
    opt = AdamW(AdamWConfig(zero1=False, warmup_steps=2))
    ck = CheckpointManager(tmp_path, async_write=async_write)
    calls = {"n": 0}

    def make_args():
        calls["n"] += 1
        return dict(
            model=model,
            optimizer=opt,
            batches=_batches(model),
            steps=12,
            ckpt=ck,
            ckpt_every=4,
            failure=FailureInjector(6 if calls["n"] == 1 else None),
            log_every=0,
            device="cpu",
        )

    res = fit_with_restarts(make_args, log=lambda s: None)
    assert res.final_step == 12
    assert res.resumed_from == 4  # restarted from the step-4 checkpoint
    assert calls["n"] == 2


def test_failure_injector_reads_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_FAILURE_STEP", "3")
    inj = FailureInjector()
    inj.check(2)
    with pytest.raises(RuntimeError, match="step 3"):
        inj.check(3)
    inj.check(3)  # fires once


def test_straggler_monitor():
    m = StragglerMonitor(threshold=2.0, warmup=2)
    flagged = [m.observe(i, 0.1) for i in range(5)]
    assert not any(flagged)
    assert m.observe(5, 0.5)  # 5x slower than EWMA
    assert not m.observe(6, 0.1)
    assert m.flagged == [5]


def test_elastic_plan():
    p = ElasticPlan.plan(256)
    assert p.new_mesh_shape == (16, 16)
    p2 = ElasticPlan.plan(128)
    assert p2.new_mesh_shape == (8, 16)
    with pytest.raises(ValueError):
        ElasticPlan.plan(100)


def test_zero1_spec_rules():
    assert zero1_spec(("tp", None), (1024, 512), 32) == ("tp", "dp")
    assert zero1_spec((None, "tp"), (100, 512), 32) == (None, "tp")  # 100 % 32 != 0
    # already dp-sharded (MoE experts): unchanged
    assert zero1_spec(("tp", None, "dp"), (16, 5120, 16384), 32) == ("tp", None, "dp")


def test_state_specs_follow_the_param_defs():
    model = _tiny_model()
    specs = AdamW(AdamWConfig(zero1=True)).state_specs(model.param_defs(), 2)
    assert specs["step"] == ()
    assert specs["m"] == specs["v"]
    assert specs["m"]["embed"] == zero1_spec(model.param_defs()["embed"].spec,
                                             model.param_defs()["embed"].shape, 2)


def test_grad_compression_trains():
    model = _tiny_model()
    opt = AdamW(AdamWConfig(zero1=False, compress_grads=True, lr=1e-3, warmup_steps=5))
    res = fit(model, opt, _batches(model, fixed=True), steps=20, log_every=0, device="cpu")
    assert np.isfinite(res.losses[-1])
    assert res.losses[-1] < res.losses[0]


def test_microbatching_matches_full_batch():
    model = _tiny_model()
    opt = AdamW(AdamWConfig(zero1=False))
    params = model.init(0, device="cpu")
    state = opt.init(params)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(5).integers(2, model.cfg.vocab, (8, 33)).astype(np.int32))}
    p1, _, m1 = make_train_step(model, opt, microbatches=1)(_clone(params), _clone(state), batch)
    p2, _, m2 = make_train_step(model, opt, microbatches=4)(_clone(params), _clone(state), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for (_, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-4)


def test_train_step_updates_in_place_and_keeps_dtypes():
    model = _tiny_model()
    opt = AdamW(AdamWConfig(zero1=False))
    params = model.init(0, device="cpu")
    state = opt.init(params)
    before = {path: t.clone() for path, t in tree_leaves(params)}
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(6).integers(2, model.cfg.vocab, (2, 17)).astype(np.int32))}
    new_p, new_s, metrics = make_train_step(model, opt)(params, state, batch)
    assert new_p is params and new_s is state and int(state["step"]) == 1
    for path, t in tree_leaves(params):
        assert t.dtype == torch.float32 and not t.requires_grad
        assert not torch.equal(t, before[path]), path  # every leaf moved
    assert metrics["loss"].dim() == 0 and not metrics["loss"].requires_grad


def test_fit_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(model, AdamW(), _batches(model), steps=1, log_every=0)


def _twin():
    spec = importlib.util.spec_from_file_location("_twin_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_training_twin_runs_on_the_host_and_its_loss_falls():
    out = _twin().main(device="cpu", steps=12, batch=4, seq=32, d_model=64, layers=2, docs=256,
                       vocab=512)
    last = out.strip().splitlines()[-1]
    assert last.startswith("done: steps=12 loss")
    first, final = (float(x) for x in last.split("loss ")[1].split(" (")[0].split(" -> "))
    assert np.isfinite(final) and final < first


def test_training_twin_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _twin().main()
