"""The port's dry run (``launch/dryrun.py``) and a traced step on a small
fake mesh, on the CPU.

Each case runs in a subprocess with its own fake process group and a
timeout (a process group is process-wide, so no test worker keeps one):

  * reduced llama3-8b's ZeRO-1 train step on a 2 x 4 ("data", "model")
    mesh of a fake process group (the twin of
    ``tests/test_sharding_dryrun.py``'s small-mesh test): it traces, its
    per-rank FLOPs are above 0 and their sum over the 8 ranks comes within
    PER_CHIP_TOL of the unsharded step's, the gradients' all-reduce and
    reduce-scatter bytes over "data" are above 0, and with ``remat`` the
    recomputed forward issues its collectives again (more of them than
    without);
  * one dry-run cell, ``llama3-8b × decode_32k × single`` on 256 fake
    ranks, whose record has the reference's keys (``fits_80G`` for
    ``fits_16G``), and whose per-rank argument bytes are the shards the
    specs give.
"""

import json
import os
import subprocess
import sys
import textwrap

from repro.launch.roofline import Roofline as RefRoofline

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the 8 ranks' FLOPs against the unsharded step's (both with remat): every
# matmul of the step splits 8 ways, so the sum is the step's (1.0 when this
# was written); replicated work could only raise it, never lower it
PER_CHIP_TOL = 0.10


def _run(code: str, timeout: int = 240) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_SMALL_MESH = textwrap.dedent(
    """
    import json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import _dtensors
    from repro_torch.launch.mesh import dp_total, make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, AdamWConfig, make_train_step

    cfg = get_arch("llama3-8b").with_reduced()
    opt = AdamW(AdamWConfig(zero1=True))
    tokens = torch.empty(8, 33, dtype=torch.int32, device="meta")

    def unsharded():
        model = build_model(cfg, attn_impl="reference")
        ap = model.abstract_params()
        return RL.analyze(make_train_step(model, opt), ap, opt.abstract_state(ap), {"tokens": tokens})[1]

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_debug_mesh(2, 4, device="cpu")
        out = {"dp_total": dp_total(mesh)}
        for remat in (True, False):
            model = build_model(cfg, attn_impl="reference", remat=remat)
            ap = model.abstract_params()
            args = (_dtensors(ap, model.param_specs(), mesh, False),
                    _dtensors(opt.abstract_state(ap), opt.state_specs(model.param_defs(), dp_total(mesh)),
                              mesh, False),
                    _dtensors({"tokens": tokens}, {"tokens": ("dp", None)}, mesh, False))
            with mesh_context(mesh, False):
                _, an = RL.analyze(make_train_step(model, opt), *args)
            out[str(remat)] = {"flops": an.flops, "by_type": an.collective_bytes,
                               "counts": sum(an.collective_counts.values()),
                               "by_axis": an.collective_bytes_by_axis(mesh)}
    finally:
        dist.destroy_process_group()
    out["unsharded_flops"] = unsharded().flops
    print(json.dumps(out))
    """
)


def test_small_mesh_train_step_traces():
    rec = _run(_SMALL_MESH)
    assert rec["dp_total"] == 2
    on = rec["True"]
    assert on["flops"] > 0
    assert on["by_type"]["all-reduce"] + on["by_type"]["reduce-scatter"] > 0
    assert on["by_axis"].get("data", 0) > 0 and on["by_axis"].get("model", 0) > 0
    ratio = 8 * on["flops"] / rec["unsharded_flops"]
    assert 1.0 <= ratio <= 1.0 + PER_CHIP_TOL, ratio
    # remat: the backward recomputes each layer's forward, collectives included
    off = rec["False"]
    assert on["counts"] > off["counts"] and on["flops"] > off["flops"]


_CELL = textwrap.dedent(
    """
    import json, pathlib, sys, tempfile
    from repro_torch.launch.dryrun import run_cell

    with tempfile.TemporaryDirectory() as d:
        rec = run_cell("llama3-8b", "decode_32k", False, pathlib.Path(d))
        rec["files"] = sorted(p.name for p in pathlib.Path(d).iterdir())
    print(json.dumps(rec))
    """
)


def test_dry_run_cell_record():
    rec = _run(_CELL)
    assert rec["status"] == "ok", rec
    ref_keys = {"arch", "shape", "mesh", "status", "n_chips", "n_params", "n_active_params", "lower_s",
                "compile_s", "memory", "roofline"}
    assert ref_keys <= set(rec)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_chips"]) == ("llama3-8b", "decode_32k", "single", 256)
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "alias_bytes", "temp_bytes", "per_device_total",
            "fits_80G"} <= set(mem)
    kw = dict(flops=1.0, hbm_bytes=1.0, collective_bytes=1.0, model_flops=1.0, n_chips=1)
    assert list(rec["roofline"]) == list(RefRoofline(**kw).as_dict())
    # per rank: bf16 weights over "model" (16), the vocabulary-parallel
    # embedding and head too; KV caches of 128 x 32768 over (data, model)
    n = rec["n_params"]
    cache = 2 * 32 * 128 * 32768 * 8 * 128 * 2 // 256
    assert mem["argument_bytes"] >= cache and mem["argument_bytes"] < n * 2 // 16 + cache + 2**20
    assert mem["alias_bytes"] == cache  # the caches are updated in place
    # the step's temporaries: a rank's peak of live bytes beyond its
    # arguments and outputs (the reference's temp_size_in_bytes), in the total
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert mem["per_device_total"] == (mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
                                       + mem["temp_bytes"])
    assert mem["fits_80G"] and rec["roofline"]["flops_per_chip"] > 0
    assert rec["roofline"]["collective_bytes_per_chip"] > 0
    assert rec["files"] == ["trace__baseline__llama3-8b__decode_32k__single.json.gz"]
