"""The port's ``CheckpointManager`` on the CPU: the cases of
``tests/test_train_infra.py`` (round trip and dedup, GC keeps the latest),
atomic and asynchronous writes, and interop with the reference's manager.

For the same carried state (a reduced model's parameters and the AdamW
state after one step, as ``fit`` saves them) the two managers write the same
``index.json`` (names, digests, shapes, dtypes) and the same object files,
byte for byte; each restores the other's checkpoint bit for bit.
``meta.json``'s ``"treedef"`` is each package's own description of the
tree and is left out of the comparison.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_arch as ref_arch
from repro.models import build_model as ref_build
from repro.train import AdamW as RefAdamW
from repro.train import AdamWConfig as RefAdamWConfig
from repro_torch.carry import opt_state_from_reference, params_from_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves


def _tiny_params():
    return build_model(get_arch("llama3-8b").with_reduced()).init(0, device="cpu")


def _flat(tree):
    """Leaves of a (params, state) tuple or a dict, in checkpoint order."""
    from repro_torch.checkpoint.manager import _named_leaves

    return _named_leaves(tree)


def test_checkpoint_roundtrip_and_dedup(tmp_path):
    params = _tiny_params()
    ck = CheckpointManager(tmp_path, async_write=False, keep=2)
    ck.save(1, params)
    ck.save(2, params)  # identical → full object dedup
    objects = list((tmp_path / "objects").glob("*.npy"))
    n_leaves = len(list(tree_leaves(params)))
    assert len(objects) <= n_leaves  # shared, not duplicated
    assert not [p for p in (tmp_path / "objects").iterdir() if p.suffix != ".npy"]  # no strays
    restored, meta = ck.restore(None, params)
    assert meta["step"] == 2
    for (_, a), (_, b) in zip(tree_leaves(params), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_keeps_latest(tmp_path):
    params = _tiny_params()
    ck = CheckpointManager(tmp_path, async_write=False, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, params)
    assert ck.all_steps() == [3, 4]


def test_async_save_snapshots_before_the_state_moves(tmp_path):
    """The host copy is taken at ``save``: an in-place update right after
    (as the optimizer's) does not reach the checkpoint."""
    params = _tiny_params()
    want = {path: t.clone() for path, t in tree_leaves(params)}
    ck = CheckpointManager(tmp_path, async_write=True)
    ck.save(5, params)
    for _, t in tree_leaves(params):
        t.add_(1.0)
    restored, meta = ck.restore(None, params)
    assert meta["step"] == 5
    for path, t in tree_leaves(restored):
        assert torch.equal(t, want[path])


def test_unfinished_snapshots_are_not_steps(tmp_path):
    ck = CheckpointManager(tmp_path, async_write=False)
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000010").mkdir()  # no index.json: never published
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(None, {})


def test_bf16_leaf_raises(tmp_path):
    ck = CheckpointManager(tmp_path, async_write=False)
    with pytest.raises(ValueError, match="bf16"):
        ck.save(1, {"w": torch.ones(3, dtype=torch.bfloat16)})


def _carried_state():
    """A reduced model's params and the AdamW state after one step, in the
    reference's arrays and carried to the port's tensors."""
    rm = ref_build(ref_arch("llama3-8b").with_reduced())
    rp = rm.init(jax.random.PRNGKey(0))
    opt = RefAdamW(RefAdamWConfig(zero1=False, compress_grads=True))
    state = opt.init(rp)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 1e-3, p.dtype), rp)
    rp, state, _ = opt.update(rp, grads, state)
    np_state = jax.tree_util.tree_map(np.asarray, (rp, state))
    port = (params_from_reference(np_state[0], device="cpu"),
            opt_state_from_reference(np_state[1], device="cpu"))
    return (rp, state), port


def test_index_and_objects_are_the_references(tmp_path):
    ref_state, port_state = _carried_state()
    RefCheckpointManager(tmp_path / "ref", async_write=False).save(7, ref_state)
    CheckpointManager(tmp_path / "port", async_write=False).save(7, port_state)
    snap = "step_00000007"
    ref_index = json.loads((tmp_path / "ref" / snap / "index.json").read_text())
    port_index = json.loads((tmp_path / "port" / snap / "index.json").read_text())
    assert port_index == ref_index
    assert "1/step" in port_index and port_index["1/step"]["dtype"] == "int32"
    assert "0/scan/l0/mixer/wq" in port_index and "1/ef/embed" in port_index
    ref_meta = json.loads((tmp_path / "ref" / snap / "meta.json").read_text())
    port_meta = json.loads((tmp_path / "port" / snap / "meta.json").read_text())
    assert {k: v for k, v in port_meta.items() if k != "treedef"} == \
        {k: v for k, v in ref_meta.items() if k != "treedef"}
    ref_objects = {p.name: p.read_bytes() for p in (tmp_path / "ref" / "objects").glob("*.npy")}
    port_objects = {p.name: p.read_bytes() for p in (tmp_path / "port" / "objects").glob("*.npy")}
    assert port_objects == ref_objects


def test_each_package_restores_the_others_checkpoint(tmp_path):
    ref_state, port_state = _carried_state()
    RefCheckpointManager(tmp_path / "ref", async_write=False).save(3, ref_state)
    CheckpointManager(tmp_path / "port", async_write=False).save(3, port_state)
    # the port restores the reference's
    got, meta = CheckpointManager(tmp_path / "ref").restore(None, port_state)
    assert meta["step"] == 3
    for (name, a), (_, b) in zip(_flat(got), _flat(port_state)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # the reference restores the port's
    back, meta = RefCheckpointManager(tmp_path / "port").restore(None, ref_state)
    assert meta["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
