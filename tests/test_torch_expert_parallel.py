"""Expert parallelism on a mesh (``models/moe.py``'s ``_moe_on_mesh``) and the
dry run's loop trip counts and temporaries (``launch/roofline.py``), on the
CPU.

  * The no-mesh MoE block against the reference's ``moe_block`` on the seeded
    numpy inputs that the mesh runs below also take (reduced llama4-scout,
    top-1, and reduced jamba, top-2; both dispatches; a prefill and a decode
    shape).
  * Four gloo ranks on a 2 x 2 ("data", "model") mesh, each its own process:
    the block's output, and every gradient leaf of a loss on it, within
    ``SHARDED_TOL`` of no mesh on every rank, for both configurations and
    dispatches, a decode step (S = 1), and an E that "model" does not divide
    (every expert gathered); the expert weights' gradients stay split over
    "model".
  * A gloo mesh of one rank: the block (both dispatches, forward, gradients,
    decode) and reduced scout's logits, loss and gradients bit for bit the
    run without a mesh.
  * The block traced on a 2 x 4 fake mesh: no collective over "model" moves
    an expert weight (they are gathered over "data" only), "model" carries
    the output's all-reduce, the 8 ranks' FLOPs sum to the unsharded
    block's within ``PER_CHIP_TOL``, and the temporaries hold a rank's
    experts, not the stack.  With an E that "model" does not divide, the
    stack is gathered, as documented.
  * ``loop_trips``: the plain attention and a reduced prefill and training
    step at S = 2048 with 512-blocks (a 4 x 4 tile grid) traced on meta
    tensors (one tile, counted 16 times) and on real CPU tensors (every
    tile): flops, traffic, raw bytes, op counts and the ``ops`` table equal.
  * ``temp_bytes``: exact on a function whose temporaries are known, equal
    on a mesh of one and without a mesh, and in ``run_cell``'s record of
    ``llama4-scout-17b-a16e x decode_32k x single``, whose collective bytes
    and FLOPs a rank are those of experts split over "model".

Every process group lives in a subprocess (a process group is process-wide,
so no test worker keeps one); the subprocesses import this file's helpers,
which import no JAX (the reference comparison imports it where it runs).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ref
from repro_torch.launch import roofline as RL
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.train import loss_and_grads

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# a 2 x 2 mesh against no mesh in bf16 compute (tests/test_torch_sharding.py):
# the partial outputs of the "model" ranks' experts are rounded to bf16 and
# summed, where the run without a mesh rounds their sum once
SHARDED_TOL = 2e-2
# the 8 ranks' FLOPs against the unsharded block's (tests/test_torch_dryrun.py):
# the expert matmuls split 8 ways; each "model" rank routes its rows over all
# E experts, so the router's FLOPs count 4 times (1.02 when this was written)
PER_CHIP_TOL = 0.10
REF_TOL = 2e-2  # tests/test_torch_moe.py's bf16 tolerance against the reference
ARCHS = {"scout": "llama4-scout-17b-a16e", "jamba": "jamba-1.5-large-398b"}
DISPATCHES = ("gather", "einsum")
# (B, S): a prefill shape with capacity drops, and a decode step (C = K)
SHAPES = {"prefill": (4, 24), "decode": (4, 1)}


def _cfg(name, E=None):
    cfg = get_arch(ARCHS[name]).with_reduced()
    return cfg if E is None else dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=E))


def _inputs(name, what, E=None):
    """The seeded numpy weights and activations of a case (the mesh runs
    below build the same ones)."""
    cfg = _cfg(name, E)
    rng = np.random.default_rng(sorted(ARCHS).index(name) * 10 + list(SHAPES).index(what))
    p = {k: (rng.standard_normal(pd.shape) * (0.3 if k == "w_gate" else 0.15) + (1.0 if pd.init == "ones" else 0.0))
         .astype(np.float32) for k, pd in M.moe_defs(cfg).items()}
    x = rng.standard_normal(SHAPES[what] + (cfg.d_model,)).astype(np.float32)
    return p, x


def _port_inputs(name, what, E=None):
    p, x = _inputs(name, what, E)
    return {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("what", list(SHAPES))
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_no_mesh_block_matches_reference(name, dispatch, what):
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs import get_arch as ref_arch
    from repro.models import moe as RM

    p, x = _inputs(name, what)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = RM.moe_block({k: jnp.asarray(v) for k, v in p.items()}, jx, ref_arch(ARCHS[name]).with_reduced(),
                        dispatch=dispatch)
    tp, tx = _port_inputs(name, what)
    got = M.moe_block(tp, tx, _cfg(name), dispatch=dispatch)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=REF_TOL, rtol=REF_TOL)


# -- four gloo ranks on a 2 x 2 mesh ---------------------------------------------

_MESH_JOB = textwrap.dedent(
    """
    import json, sys
    import torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[3])
    from test_torch_expert_parallel import ARCHS, DISPATCHES, SHAPES, _cfg, _port_inputs
    from repro_torch.distributed.sharding import mesh_context, shard_tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe as M

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
    torch.manual_seed(0)

    def err(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    out = {}
    try:
        mesh = make_debug_mesh(2, 2, device="cpu")
        cases = [(n, d, w, None) for n in ARCHS for d in DISPATCHES for w in SHAPES]
        cases.append(("scout", "gather", "prefill", 3))  # "model" (2) does not divide E
        for name, dispatch, what, E in cases:
            cfg = _cfg(name, E)
            defs = M.moe_defs(cfg)
            p, x = _port_inputs(name, what, E)
            p = {k: v.requires_grad_() for k, v in p.items()}
            y = M.moe_block(p, x, cfg, dispatch=dispatch)
            g = torch.autograd.grad(y.float().square().sum(), list(p.values()))
            pm = shard_tree({k: v.detach() for k, v in p.items()}, {k: d.spec for k, d in defs.items()},
                            mesh, False)
            pm = {k: v.requires_grad_() for k, v in pm.items()}
            xm = shard_tree({"x": x}, {"x": ("dp", None, None)}, mesh, False)["x"]
            with mesh_context(mesh, False):
                ym = M.moe_block(pm, xm, cfg, dispatch=dispatch)
                gm = torch.autograd.grad(ym.float().square().sum(), list(pm.values()))
            lo = xm.to_local().shape[0] * mesh.get_coordinate()[0]
            mine = y[lo:lo + xm.to_local().shape[0]]
            out[f"{name}/{dispatch}/{what}/{E}"] = {
                "out": err(ym.to_local(), mine),
                "out_placements": [str(q) for q in ym.placements],
                "grads": {k: err(b.full_tensor(), a) for k, a, b in zip(p, g, gm)},
                "w_in_placements": [str(q) for q in gm[list(p).index("w_in")].placements],
            }
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()
    """
)

_CASES = [f"{n}/{d}/{w}/None" for n in ARCHS for d in DISPATCHES for w in SHAPES] + ["scout/gather/prefill/3"]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def two_by_two():
    """Each of the four ranks' results, from one run of every case."""
    port, here = _free_port(), os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_JOB, str(r), str(port), here], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


@pytest.mark.parametrize("case", _CASES)
def test_two_by_two_output_matches_no_mesh(two_by_two, case):
    for rank in two_by_two:
        assert rank[case]["out"] <= SHARDED_TOL, (case, rank[case]["out"])
        # the block's output keeps its input's rows: batch over "data"
        assert rank[case]["out_placements"] == ["S(0)", "R"]


@pytest.mark.parametrize("case", _CASES)
def test_two_by_two_gradients_match_no_mesh(two_by_two, case):
    for rank in two_by_two:
        grads = rank[case]["grads"]
        assert set(grads) == {"ln", "w_gate", "w_in", "w_out"}
        assert max(grads.values()) <= SHARDED_TOL, (case, grads)
        # the expert weights' gradients keep their parameters' layout:
        # experts over "model", the d_ff axis over "data"
        assert rank[case]["w_in_placements"] == ["S(2)", "S(0)"]


# -- a mesh of one: bit for bit ---------------------------------------------------

_MESH_OF_ONE = textwrap.dedent(
    """
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[2])
    from test_torch_expert_parallel import DISPATCHES, _cfg, _port_inputs
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import local_tree, mesh_context, shard_tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import loss_and_grads

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{sys.argv[1]}", rank=0, world_size=1)
    rec = {}
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        cfg = _cfg("jamba")
        defs = M.moe_defs(cfg)
        for dispatch in DISPATCHES:
            for what in ("prefill", "decode"):
                p, x = _port_inputs("jamba", what)
                p = {k: v.requires_grad_() for k, v in p.items()}
                y = M.moe_block(p, x, cfg, dispatch=dispatch)
                g = torch.autograd.grad(y.float().square().sum(), list(p.values()))
                pm = shard_tree({k: v.detach() for k, v in p.items()}, {k: d.spec for k, d in defs.items()},
                                mesh, False)
                pm = {k: v.requires_grad_() for k, v in pm.items()}
                with mesh_context(mesh, False):
                    ym = M.moe_block(pm, shard_tree({"x": x}, {"x": ("dp", None, None)}, mesh, False)["x"], cfg,
                                     dispatch=dispatch)
                    gm = torch.autograd.grad(ym.float().square().sum(), list(pm.values()))
                rec[f"block/{dispatch}/{what}"] = torch.equal(ym.to_local(), y) and all(
                    torch.equal(a, b.to_local()) for a, b in zip(g, gm))
        # reduced scout cut to its first pattern period (every layer MoE):
        # logits, loss and gradients
        scfg = get_arch("llama4-scout-17b-a16e").with_reduced()
        scfg = dataclasses.replace(scfg, n_layers=4, pattern=scfg.pattern[:4])
        model = build_model(scfg)
        params = model.init(0, device="cpu")
        batch = {"tokens": torch.randint(2, scfg.vocab, (2, 33), generator=torch.Generator().manual_seed(1))}
        logits = model.forward(params, batch["tokens"][:, :-1])
        loss, grads = loss_and_grads(model, params, batch)
        pd = shard_tree(params, model.param_specs(), mesh, False)
        bd = shard_tree(batch, {"tokens": ("dp", None)}, mesh, False)
        with mesh_context(mesh, False):
            logits_m = model.forward(pd, bd["tokens"][:, :-1])
            loss_m, grads_m = loss_and_grads(model, pd, bd)
        gm = dict(tree_leaves(local_tree(grads_m)))
        rec["model/logits"] = torch.equal(logits, logits_m.full_tensor())
        rec["model/loss"] = torch.equal(loss, loss_m.full_tensor())
        rec["model/grads"] = [p for p, t in tree_leaves(grads) if not torch.equal(t, gm[p])] == []
        print(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def mesh_of_one():
    env = dict(os.environ, PYTHONPATH=SRC)
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _MESH_OF_ONE, str(_free_port()), here], capture_output=True,
                         text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", [f"block/{d}/{w}" for d in DISPATCHES for w in ("prefill", "decode")]
                         + ["model/logits", "model/loss", "model/grads"])
def test_mesh_of_one_is_bit_identical(mesh_of_one, case):
    assert mesh_of_one[case] is True


# -- the block traced on a 2 x 4 fake mesh ---------------------------------------

_FAKE_MESH = textwrap.dedent(
    """
    import json, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sys.path.insert(0, sys.argv[1])
    from test_torch_expert_parallel import _cfg
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import _dtensors
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe as M

    def meta(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    rec = {}
    for E in (8, 6):  # 2 experts a "model" rank; 6 over 4 ranks: gathered
        cfg = _cfg("scout", E)
        defs = M.moe_defs(cfg)
        p = {k: meta(d.shape) for k, d in defs.items()}
        x = meta((8, 64, cfg.d_model))
        for dispatch in ("gather", "einsum"):
            flops = RL.analyze(lambda p, x: M.moe_block(p, x, cfg, dispatch=dispatch, impl="reference"), p, x)[1].flops
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
            try:
                mesh = make_debug_mesh(2, 4, device="cpu")
                groups = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
                pm = _dtensors(p, {k: d.spec for k, d in defs.items()}, mesh, False)
                xm = _dtensors(x, ("dp", None, None), mesh, False)
                with mesh_context(mesh, False):
                    _, an = RL.analyze(lambda p, x: M.moe_block(p, x, cfg, dispatch=dispatch, impl="reference"),
                                      pm, xm)
            finally:
                dist.destroy_process_group()
            colls = []
            for key, r in an.ops.items():
                if key.startswith("_c10d_functional::") and "@" in key:
                    op, rest = key.split(" ", 1)
                    shapes, group = rest.rsplit(" @", 1)
                    colls.append({"op": op.split("::")[1], "axis": groups[group], "operand": shapes,
                                  "bytes": r["bytes"] / r["count"], "count": r["count"]})
            rec[f"{E}/{dispatch}"] = {
                "flops": an.flops, "unsharded_flops": flops, "collectives": colls,
                "temp": an.temp_bytes,
                "weights": {k: [str(q) for q in v.placements] for k, v in pm.items()},
                "local_weights": {k: list(v.to_local().shape) for k, v in pm.items()},
            }

    # temp_bytes of reduced models' prefill on a fake mesh of one and without one
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    one = {}
    for arch in ("llama3-8b", "llama4-scout-17b-a16e"):
        model = build_model(get_arch(arch).with_reduced(), attn_impl="reference")
        ap = model.abstract_params()
        tokens = {"tokens": torch.empty(2, 256, dtype=torch.int32, device="meta")}
        plain = RL.analyze(model.forward_step, ap, tokens)[1].temp_bytes
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
        try:
            mesh = make_debug_mesh(1, 1, device="cpu")
            args = (_dtensors(ap, model.param_specs(), mesh, False),
                    _dtensors(tokens, {"tokens": ("dp", None)}, mesh, False))
            with mesh_context(mesh, False):
                meshed = RL.analyze(model.forward_step, *args)[1].temp_bytes
        finally:
            dist.destroy_process_group()
        one[arch] = [plain, meshed]

    # the dry run's scout decode cell (256 fake ranks)
    import pathlib, tempfile
    from repro_torch.launch.dryrun import run_cell

    with tempfile.TemporaryDirectory() as d:
        cell = run_cell("llama4-scout-17b-a16e", "decode_32k", False, pathlib.Path(d))
    print(json.dumps({"block": rec, "one_rank_temp": one, "scout_cell": cell}))
    """
)


@pytest.fixture(scope="module")
def fake_mesh():
    env = dict(os.environ, PYTHONPATH=SRC)
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _FAKE_MESH, here], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _stack_bytes(cfg, experts):
    """bf16 bytes of ``experts`` experts' w_in and w_out, whole."""
    return experts * 3 * cfg.d_model * cfg.moe.d_ff_expert * 2


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_fake_mesh_gathers_experts_over_data_only(fake_mesh, dispatch):
    rec, cfg = fake_mesh["block"][f"8/{dispatch}"], _cfg("scout", 8)
    colls = rec["collectives"]
    # the block's output (4 rows a "data" rank) all-reduced over "model"
    out = f"bf16[4, 64, {cfg.d_model}]"
    assert [c for c in colls if c["axis"] == "model"] == [
        {"op": "all_reduce", "axis": "model", "operand": out, "bytes": 4 * 64 * cfg.d_model * 2, "count": 1}]
    # the two expert weights, each rank's two experts, gathered over "data"
    gathers = [c for c in colls if c["axis"] == "data"]
    assert sorted(c["operand"] for c in gathers) == sorted(
        f"bf16{rec['local_weights'][k]}" for k in ("w_in", "w_out"))
    assert all(c["op"] == "all_gather_into_tensor" for c in gathers)
    # the temporaries hold this rank's experts gathered, not the stack
    assert _stack_bytes(cfg, 2) <= rec["temp"] < _stack_bytes(cfg, 8)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_fake_mesh_ranks_split_the_flops(fake_mesh, dispatch):
    rec = fake_mesh["block"][f"8/{dispatch}"]
    ratio = 8 * rec["flops"] / rec["unsharded_flops"]
    assert 1.0 <= ratio <= 1.0 + PER_CHIP_TOL, ratio


def test_fake_mesh_uneven_experts_are_gathered(fake_mesh):
    """E = 6 over 4 "model" ranks: every rank gathers every expert (over
    both axes) and computes them all; the output needs no all-reduce."""
    rec, cfg = fake_mesh["block"]["6/gather"], _cfg("scout", 6)
    ops = {(c["op"], c["axis"]) for c in rec["collectives"]}
    assert ("all_reduce", "model") not in ops
    assert ("all_gather_into_tensor", "model") in ops
    assert rec["temp"] >= _stack_bytes(cfg, 6)
    assert 8 * rec["flops"] / rec["unsharded_flops"] > 3.5  # each "model" rank runs all 6


# -- loop trip counts ----------------------------------------------------------------


def _trace(kind, device):
    """The trace of one of the trip-counted cases on ``device`` ("cpu" with
    seeded values, "meta" without)."""
    S = 2048
    if kind.startswith("attention"):
        gen = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, S, h, 16, generator=gen).to(device) for h in (4, 2, 2))
        if kind == "attention":
            return RL.analyze(lambda q, k, v: ref.flash_attention_reference(q, k, v, window=700), q, k, v)[1]
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        return RL.analyze(lambda q, k, v: torch.autograd.grad(
            ref.flash_attention_reference(q, k, v).square().sum(), (q, k, v)), q, k, v)[1]
    cfg = get_arch("llama3-8b").with_reduced()
    model = build_model(cfg, attn_impl="reference")
    if device == "cpu":
        params = model.init(0, device="cpu")
        tokens = torch.randint(2, cfg.vocab, (1, S + 1), generator=torch.Generator().manual_seed(1))
    else:
        params = model.abstract_params()
        tokens = torch.empty(1, S + 1, dtype=torch.int64, device="meta")
    if kind == "prefill":
        return RL.analyze(model.forward_step, params, {"tokens": tokens[:, :-1]})[1]
    return RL.analyze(lambda p, b: loss_and_grads(model, p, b), params, {"tokens": tokens})[1]


@pytest.mark.parametrize("kind", ["attention", "attention_grad", "prefill", "train"])
def test_trip_counted_trace_equals_the_full_loop(kind):
    full, one = _trace(kind, "cpu"), _trace(kind, "meta")
    assert one.flops == full.flops and one.flops > 0
    assert one.traffic_bytes == full.traffic_bytes
    assert one.raw_bytes == full.raw_bytes
    assert one.n_ops == full.n_ops
    assert one.ops == full.ops
    assert one.total_collective_bytes == full.total_collective_bytes == 0


def test_loop_trips_scope():
    x = torch.ones(8, 8)
    _, plain = RL.analyze(lambda x: x @ x, x)

    def body(x):
        with RL.loop_trips(3):
            with RL.loop_trips(2):
                y = x @ x
        return y @ x

    _, an = RL.analyze(body, x)
    assert an.flops == 7 * plain.flops and an.n_ops == 7 * plain.n_ops
    assert an.ops == {k: {kk: 7 * vv for kk, vv in r.items()} for k, r in plain.ops.items()}
    assert an.temp_bytes == 8 * 8 * 4  # y, allocated once whatever its trips


# -- temporaries --------------------------------------------------------------------


def _known(x):
    """Temporaries by construction: ``a`` 400 bytes, its view ``b`` nothing,
    ``c`` 396 (peak 796 with ``a``), ``a`` freed, ``d`` 396 beside ``c``;
    the output (4 bytes) is not a temporary."""
    a = x * 2
    b = a[1:]
    c = b + 1
    del a, b
    d = c.exp()
    del c
    return d.sum()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_temp_bytes_exact(device):
    _, an = RL.analyze(_known, torch.ones(100, device=device))
    assert an.temp_bytes == 796
    assert an.temp_at_peak == {"aten::mul f32[100]": 400, "aten::add f32[99]": 396}
    # a view or an in-place result of an argument is the argument's
    _, an = RL.analyze(lambda x: x[2:].mul_(2).t(), torch.ones(10, 10, device=device))
    assert an.temp_bytes == 0


def test_temp_bytes_on_a_mesh_of_one(fake_mesh):
    for arch, (plain, meshed) in fake_mesh["one_rank_temp"].items():
        assert plain > 0 and meshed == plain, (arch, plain, meshed)


def test_scout_decode_cell_is_expert_parallel(fake_mesh):
    """The record of ``llama4-scout-17b-a16e x decode_32k x single`` (256
    fake ranks, model output): each rank gathers its one expert over "data"
    (1/256 of 48 layers x 4.03 GB of bf16 experts, ~0.755e9 bytes) where it
    gathered all 16 before (12.85e9 collective bytes and 1.566e12 FLOPs a
    rank), and its temporaries count in its total."""
    rec = fake_mesh["scout_cell"]
    assert rec["status"] == "ok", rec
    roof, mem = rec["roofline"], rec["memory"]
    assert roof["collective_bytes_per_chip"] < 2.0e9
    assert roof["flops_per_chip"] < 1.566e12
    experts = 48 * 16 * 3 * 5120 * 8192 * 2  # every layer's bf16 expert stack
    assert rec["collective_bytes_by_axis"]["data"] >= experts / 256
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert mem["per_device_total"] == (mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
                                       + mem["temp_bytes"])
