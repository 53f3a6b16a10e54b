"""The port's sharding layer against the reference's, on the CPU.

The logical→physical translation entry for entry; for every arch of the
registry at ``with_reduced()``, the parameter specs (also under
``zero3_weights``), the inputs (shapes, dtypes, specs) of every applicable
shape, the decode caches' specs and the ZeRO-1 optimizer-state specs at
dp 2 and 16, leaf for leaf (these skip where JAX is missing: the card's
machine, where the rest of the file runs).  DTensor placements and ``constrain`` on stub
meshes.  Then, in a subprocess with its own one-rank gloo process group (a
process group is process-wide, so no test worker keeps one), reduced
llama3-8b on a DTensor mesh of one: logits, loss, gradients (also in two
microbatches), a ZeRO-1 AdamW step and a ``restore(shardings=)`` all
bit-identical to the run without a mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.configs import shape_applicable as ref_applicable
from repro.configs.registry import ARCHS as REF_ARCHS
from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.sharding import constrain, logical_to_physical, mesh_context, placements
from repro_torch.models import build_model
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves
from repro_torch.train import AdamW, AdamWConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def ref():
    """The reference's JAX modules (the card's machine has no JAX: there the
    tests that compare with them skip, and the rest run)."""
    jax = pytest.importorskip("jax")
    from repro.distributed import sharding
    from repro.models import build_model, encdec, transformer
    from repro.train import AdamW as RefAdamW
    from repro.train import AdamWConfig as RefAdamWConfig

    return types.SimpleNamespace(jax=jax, l2p=sharding.logical_to_physical, build=build_model, E=encdec,
                                 T=transformer, AdamW=RefAdamW, AdamWConfig=RefAdamWConfig)

SPECS = [
    ("dp", "tp"),
    ("dp", None),
    (("dp", "tp"), None),
    (None,),
    (),
    ("tp", None, ("dp",)),
    (None, ("dp", "tp"), None, None),
    ((None, "tp"), "dp"),
]


def _is_spec(s):
    return isinstance(s, tuple) and all(x is None or isinstance(x, (str, tuple)) for x in s)


def _ref_leaves(tree, is_leaf=None):
    """``{path: leaf}`` of a reference tree, paths as the port's."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


def _port_specs(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = t

    walk(tree, "")
    return out


def _ref_specs(tree):
    return _ref_leaves(tree, is_leaf=_is_spec)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_logical_to_physical(ref, spec, multi_pod):
    assert logical_to_physical(spec, multi_pod) == tuple(ref.l2p(spec, multi_pod))


def test_logical_to_physical_cases():
    assert logical_to_physical(("dp", "tp"), False) == ("data", "model")
    assert logical_to_physical(("dp", None), True) == (("pod", "data"), None)
    assert logical_to_physical((("dp", "tp"), None), False) == (("data", "model"), None)
    assert logical_to_physical((None,), True) == (None,)
    with pytest.raises(ValueError):
        logical_to_physical(("sp",), False)


def _stub_mesh(names):
    return types.SimpleNamespace(mesh_dim_names=names)


def test_placements():
    single, multi = _stub_mesh(("data", "model")), _stub_mesh(("pod", "data", "model"))
    assert placements(("data", "model"), single) == [Shard(0), Shard(1)]
    assert placements((None, "data"), single) == [Shard(1), Replicate()]
    assert placements((), single) == [Replicate(), Replicate()]
    assert placements((("pod", "data"), None), multi) == [Shard(0), Shard(0), Replicate()]
    assert placements((None, ("data", "model")), single) == [Shard(1), Shard(1)]
    with pytest.raises(ValueError, match="order"):
        placements((("model", "data"),), single)
    with pytest.raises(ValueError, match="no 'pod'"):
        placements((("pod", "data"),), single)
    with pytest.raises(ValueError, match="two dimensions"):
        placements(("data", "data"), single)


def test_constrain_outside_and_inside_a_mesh():
    x = torch.ones(2, 3)
    assert constrain(x, ("dp", None)) is x
    with mesh_context(_stub_mesh(("data", "model")), False):
        with pytest.raises(TypeError, match="plain Tensor"):
            constrain(x, ("dp", None))
    assert constrain(x, ("dp", None)) is x


@pytest.mark.parametrize("zero3", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(ref, arch, zero3):
    cfg = dataclasses.replace(get_arch(arch).with_reduced(), zero3_weights=zero3)
    ref_cfg = dataclasses.replace(ref_get_arch(arch).with_reduced(), zero3_weights=zero3)
    port, rm = build_model(cfg), ref.build(ref_cfg)
    want = _ref_specs(rm.param_specs())
    assert _port_specs(port.param_specs()) == want
    # the abstract parameters: meta tensors of the reference's shapes and dtypes
    abstract = dict(tree_leaves(port.abstract_params()))
    ref_abstract = _ref_leaves(rm.abstract_params())
    assert sorted(abstract) == sorted(ref_abstract)
    for path, t in abstract.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref_abstract[path].shape), path
        assert str(t.dtype).replace("torch.", "") == str(ref_abstract[path].dtype), path
    for dp in (2, 16):
        for zero1 in (True, False):
            got = AdamW(AdamWConfig(zero1=zero1)).state_specs(port.param_defs(), dp)
            ref_state = ref.AdamW(ref.AdamWConfig(zero1=zero1)).state_specs(rm.param_defs(), dp)
            assert _port_specs(got) == _ref_specs(ref_state), (dp, zero1)
    state = dict(tree_leaves(AdamW().abstract_state(port.abstract_params())))
    ref_state = _ref_leaves(ref.AdamW().abstract_state(rm.abstract_params()))
    assert sorted(state) == sorted(ref_state)
    for path, t in state.items():
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == (
            tuple(ref_state[path].shape), str(ref_state[path].dtype)), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_reference(ref, arch):
    port, rm = build_model(get_arch(arch).with_reduced()), ref.build(ref_get_arch(arch).with_reduced())
    assert sorted(SHAPES) == sorted(REF_SHAPES)
    for name in SHAPES:
        if not ref_applicable(rm.cfg, REF_SHAPES[name])[0]:
            continue
        inputs, specs = port.input_specs(SHAPES[name])
        ref_inputs, ref_specs = rm.input_specs(REF_SHAPES[name])
        assert _port_specs(specs) == _ref_specs(ref_specs), name
        got, want = dict(tree_leaves(inputs)), _ref_leaves(ref_inputs)
        assert sorted(got) == sorted(want), name
        for path, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == (
                tuple(want[path].shape), str(want[path].dtype)), (name, path)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(ref, arch):
    cfg, ref_cfg = get_arch(arch).with_reduced(), ref_get_arch(arch).with_reduced()
    for long_context in (False, True):
        if cfg.family == "audio":
            got, want = E.encdec_cache_specs(cfg, long_context), ref.E.encdec_cache_specs(ref_cfg, long_context)
        else:
            got, want = T.lm_cache_specs(cfg, long_context), ref.T.lm_cache_specs(ref_cfg, long_context)
        assert _port_specs(got) == _ref_specs(want), long_context


def test_registries_agree():
    assert sorted(ARCHS) == sorted(REF_ARCHS)


_MESH_OF_ONE = textwrap.dedent(
    """
    import json, socket, tempfile
    import torch, torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (local_tree, mesh_context, shard_tree,
                                                  spec_tree_to_shardings)
    from repro_torch.launch.mesh import dp_total, make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import AdamW, AdamWConfig, loss_and_grads, make_train_step

    torch.manual_seed(0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        cfg = get_arch("llama3-8b").with_reduced()
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(2, cfg.vocab, (2, 33), generator=gen)}
        logits = model.forward(params, batch["tokens"][:, :-1])
        loss, grads = loss_and_grads(model, params, batch)
        pd = shard_tree(params, model.param_specs(), mesh, False)
        bd = shard_tree(batch, {"tokens": ("dp", None)}, mesh, False)
        with mesh_context(mesh, False):
            logits_m = model.forward(pd, bd["tokens"][:, :-1])
            loss_m, grads_m = loss_and_grads(model, pd, bd)
        gm = dict(tree_leaves(local_tree(grads_m)))
        # two microbatches of 2 rows: on a mesh of one each rank's split is
        # the plain split (DTensor cannot squeeze a sharded batch of one row)
        batch4 = {"tokens": torch.randint(2, cfg.vocab, (4, 33), generator=gen)}
        loss2, grads2 = loss_and_grads(model, params, batch4, microbatches=2)
        bd4 = shard_tree(batch4, {"tokens": ("dp", None)}, mesh, False)
        with mesh_context(mesh, False):
            loss2_m, grads2_m = loss_and_grads(model, pd, bd4, microbatches=2)
        g2 = dict(tree_leaves(local_tree(grads2_m)))

        def dims(t):  # the tensor dimension each mesh dimension shards, or None
            return [p.dim if p.is_shard() else None for p in t.placements]

        rec = {"placements": dims(pd["scan"]["l0"]["mixer"]["wq"]),
               "microbatches": torch.equal(loss2, loss2_m.full_tensor())
               and all(torch.equal(g, g2[p]) for p, g in tree_leaves(grads2)),
               "logits": torch.equal(logits, logits_m.full_tensor()),
               "loss": torch.equal(loss, loss_m.full_tensor()),
               "grads_differ": [p for p, g in tree_leaves(grads) if not torch.equal(g, gm[p])]}

        opt = AdamW(AdamWConfig(warmup_steps=1, zero1=True))
        step = make_train_step(model, opt)
        p1 = tree_map(torch.clone, params)
        p1, s1, m1 = step(p1, opt.init(p1), batch)
        p2 = shard_tree(tree_map(torch.clone, params), model.param_specs(), mesh, False)
        s2 = shard_tree(opt.init(params), opt.state_specs(model.param_defs(), dp_total(mesh)), mesh, False)
        rec["moment_placements"] = dims(s2["m"]["scan"]["l0"]["mixer"]["wq"])
        with mesh_context(mesh, False):
            p2, s2, m2 = step(p2, s2, bd)
        got_p, got_s = dict(tree_leaves(local_tree(p2))), dict(tree_leaves(local_tree(s2)))
        rec["step_params_differ"] = [p for p, t in tree_leaves(p1) if not torch.equal(t, got_p[p])]
        rec["step_state_differ"] = [p for p, t in tree_leaves(s1) if not torch.equal(t, got_s[p])]
        rec["metrics"] = all(torch.equal(m1[k], m2[k].full_tensor()) for k in m1)

        with tempfile.TemporaryDirectory() as d:
            ck = CheckpointManager(d, async_write=False)
            ck.save(1, p1)
            shardings = spec_tree_to_shardings(model.param_specs(), mesh, False)
            back, _ = ck.restore(1, p1, shardings=shardings)
            kinds = {type(t).__name__ for _, t in tree_leaves(back)}
            back = dict(tree_leaves(local_tree(back)))
            rec["restore_kinds"] = sorted(kinds)
            rec["restore_differ"] = [p for p, t in tree_leaves(p1) if not torch.equal(t, back[p])]
        print(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    """
)


def test_mesh_of_one_is_bit_identical():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _MESH_OF_ONE], capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["placements"] == [None, 2]  # (layers, d, heads): heads over "model"
    assert rec["moment_placements"] == [0, 2]  # ZeRO-1 adds "dp" on the first free axis
    assert rec["logits"] and rec["loss"] and rec["microbatches"]
    assert rec["grads_differ"] == []
    assert rec["step_params_differ"] == [] and rec["step_state_differ"] == [] and rec["metrics"]
    assert rec["restore_kinds"] == ["DTensor"]
    assert rec["restore_differ"] == []


_TWO_BY_TWO = textwrap.dedent(
    """
    import json, sys
    import torch, torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import local_tree, mesh_context, shard_tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves, zeros_tree
    from repro_torch.train import loss_and_grads

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
    try:
        mesh = make_debug_mesh(2, 2, device="cpu")
        cfg = get_arch("llama3-8b").with_reduced()
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        batch = {"tokens": torch.randint(2, cfg.vocab, (4, 33), generator=torch.Generator().manual_seed(1))}
        logits = model.forward(params, batch["tokens"][:, :-1])
        loss, grads = loss_and_grads(model, params, batch)
        pd = shard_tree(params, model.param_specs(), mesh, False)
        bd = shard_tree(batch, {"tokens": ("dp", None)}, mesh, False)
        with mesh_context(mesh, False):
            logits_m = model.forward(pd, bd["tokens"][:, :-1])
            loss_m, grads_m = loss_and_grads(model, pd, bd)
        gm = dict(tree_leaves(local_tree(grads_m)))
        rec = {"loss": [float(loss), float(loss_m.full_tensor())],
               "logits": float((logits_m.full_tensor().float() - logits.float()).abs().max()
                               / logits.float().abs().max()),
               "grads": {p: float((gm[p] - g).norm() / g.norm()) for p, g in tree_leaves(grads)},
               "decode": []}
        # decode on caches split batch over "data" and sequence over "model"
        # (8 positions, 4 a rank: the fifth step writes the second rank's part)
        caches = zeros_tree(T.lm_cache_shapes(cfg, 4, 8), "cpu")
        caches_m = shard_tree(zeros_tree(T.lm_cache_shapes(cfg, 4, 8), "cpu"), T.lm_cache_specs(cfg, False),
                              mesh, False)
        for t in range(6):
            tok = batch["tokens"][:, t]
            want, caches = model.decode_step(params, caches, tok, t)
            step = shard_tree({"t": tok, "p": torch.full((), t)}, {"t": ("dp",), "p": ()}, mesh, False)
            with mesh_context(mesh, False):
                got, caches_m = model.decode_step(pd, caches_m, step["t"], step["p"])
            rec["decode"].append(float((got.full_tensor() - want).abs().max() / want.abs().max()))
        # reduced llama4-scout's MoE block alone (the whole model's router
        # gradients differ where bf16 reorderings upstream reroute tokens)
        from repro_torch.models import moe as M
        from repro_torch.models.layers import init_tree
        mcfg = get_arch("llama4-scout-17b-a16e").with_reduced()
        defs = M.moe_defs(mcfg)
        p = {k: v.requires_grad_() for k, v in init_tree(defs, torch.Generator().manual_seed(0), "cpu").items()}
        x = torch.randn(4, 32, mcfg.d_model, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
        y = M.moe_block(p, x, mcfg)
        g = torch.autograd.grad(y.float().square().sum(), list(p.values()))
        pm = shard_tree({k: v.detach() for k, v in p.items()}, {k: d.spec for k, d in defs.items()}, mesh, False)
        pm = {k: v.requires_grad_() for k, v in pm.items()}
        with mesh_context(mesh, False):
            ym = M.moe_block(pm, shard_tree({"x": x}, {"x": ("dp", None, None)}, mesh, False)["x"], mcfg)
            gm = torch.autograd.grad(ym.float().square().sum(), list(pm.values()))
        rec["moe"] = float((ym.full_tensor().float() - y.float()).abs().max() / y.float().abs().max())
        rec["moe_grads"] = {k: float((b.full_tensor() - a).norm() / a.norm()) for k, a, b in zip(p, g, gm)}
        if rank == 0:
            print(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    """
)
# a 2 x 2 mesh against no mesh in bf16 compute: the row-parallel projections
# sum their partial products in another order, so the bits differ; the
# tolerances are the training tests' against jax.grad (2e-2 a leaf) and
# tests/test_kernels.py's bf16 2e-2
SHARDED_TOL = 2e-2


def test_two_by_two_mesh_matches_no_mesh():
    """Four gloo ranks on a 2 x 2 ("data", "model") mesh, each its own
    process: the loss, logits and every gradient leaf of reduced llama3-8b
    (the KV heads replicated beside split query heads, the vocabulary split
    in the embedding, the head and the loss) and six decode steps on caches
    split over both axes, against the same calls without a mesh."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_BY_TWO, str(r), str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    rec = json.loads(outs[0][0].strip().splitlines()[-1])
    loss, loss_m = rec["loss"]
    assert abs(loss_m - loss) <= 1e-3 * abs(loss)
    assert rec["logits"] <= SHARDED_TOL
    assert max(rec["grads"].values()) <= SHARDED_TOL, rec["grads"]
    assert max(rec["decode"]) <= SHARDED_TOL, rec["decode"]
    assert rec["moe"] <= SHARDED_TOL and max(rec["moe_grads"].values()) <= SHARDED_TOL, rec["moe_grads"]

