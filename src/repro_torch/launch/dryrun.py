"""Multi-pod dry run (the port of ``launch/dryrun.py``).

For every (architecture × input shape × mesh) cell:
  * build the step function (train_step for train_4k, forward for
    prefill_32k, serve_step for decode_32k / long_500k),
  * lay its parameters, optimizer state and inputs out as DTensors on a
    production mesh, each rank's shard a meta tensor (no storage), over a
    fake process group of 256 or 512 ranks
    (``torch.testing._internal.distributed.fake_pg``): this process is rank
    0, and the collectives complete without moving data,
  * run the step once under ``launch/roofline.py``'s trace (JAX lowered
    and compiled it: success proves the sharding is coherent, here that
    DTensor can run every op of the step on these placements),
  * sum the per-rank shard bytes of the arguments and outputs (torch has no
    ``memory_analysis()``), and add the step's temporaries: the trace's
    ``temp_bytes``, the peak of the bytes live in the storages that the
    rank's local ops allocate and that are not outputs (``roofline.py``),
    as the reference adds ``temp_size_in_bytes``;
  * derive the three roofline terms with H100 constants and write the cell
    record to a JSON file.

The record keeps the reference's keys, but ``fits_16G`` (TPU v5e) is
``fits_80G`` (one H100), ``lower_s`` is the seconds to build the mesh and
the arguments and ``compile_s`` those of the traced run.  In place of the
HLO file, the trace's ops (each op and local shapes once, with its count,
flops and bytes) are saved gzipped beside the record, so re-analysis needs
no rerun.  The terms are model output, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
      --shape decode_32k --mesh single --out build/dryrun
"""

from __future__ import annotations

import argparse
import gzip
import json
import math
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_arch, shape_applicable
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.sharding import logical_to_physical, mesh_context, placements
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import dp_total, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.train_step import make_train_step

DEVICE_BYTES = 80e9  # one H100's HBM (NVIDIA H100 data sheet, SXM)


def _local_shape(shape, where, mesh):
    """Rank 0's shard shape of a tensor of ``shape`` under ``where``: each
    sharded dimension chunked as ``torch.chunk`` (and DTensor) chunks it,
    mesh dimension by mesh dimension."""
    out = list(shape)
    for p, n in zip(where, mesh.shape):
        if p.is_shard():
            out[p.dim] = min(out[p.dim], math.ceil(out[p.dim] / n)) if out[p.dim] else 0
    return tuple(out)


def _dtensors(abstract, specs, mesh, multi_pod):
    """Each meta tensor of ``abstract`` as a DTensor on ``mesh``, laid out by
    its logical spec, whose local shard is a meta tensor of rank 0's
    shape."""
    from torch.distributed.tensor import DTensor

    if isinstance(abstract, dict):
        return {k: _dtensors(abstract[k], specs[k], mesh, multi_pod) for k in abstract}
    where = placements(logical_to_physical(specs, multi_pod), mesh)
    local = torch.empty(_local_shape(abstract.shape, where, mesh), dtype=abstract.dtype, device="meta")
    return DTensor.from_local(local, mesh, where, run_check=False, shape=abstract.shape,
                              stride=abstract.stride())


def _bf16_params(abstract):
    """Serving holds the weights in bf16: every fp32 leaf of two or more
    dimensions."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=torch.bfloat16, device="meta")
                    if t.dtype == torch.float32 and t.dim() >= 2 else t, abstract)


def _local_bytes(tree) -> int:
    """Bytes this rank holds of the DTensors (and tensors) of ``tree``."""
    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += RL._shape_bytes(loc.shape, loc.dtype)
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for _, t in tree_leaves(tree)]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path, tag: str = "baseline"):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "skipped" if not ok else "pending",
    }
    if not ok:
        rec["skip_reason"] = why
        return rec

    t0 = time.time()
    n_chips = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        model = build_model(cfg, attn_impl="reference", remat=True)
        inputs, input_spec = model.input_specs(shape)

        def shard(abstract, specs):
            return _dtensors(abstract, specs, mesh, multi_pod)

        with mesh_context(mesh, multi_pod):
            if shape.kind == "train":
                opt = AdamW(AdamWConfig(zero1=True))
                abstract_params = model.abstract_params()
                args = (shard(abstract_params, model.param_specs()),
                        shard(opt.abstract_state(abstract_params),
                              opt.state_specs(model.param_defs(), dp_total(mesh))),
                        shard(inputs, input_spec))
                step = make_train_step(model, opt, microbatches=cfg.train_microbatches)
                model_flops = RL.train_model_flops(
                    model.n_active_params(), shape.global_batch * shape.seq_len)
            elif shape.kind == "prefill":
                args = (shard(_bf16_params(model.abstract_params()), model.param_specs()),
                        shard(inputs, input_spec))
                step = model.forward_step
                model_flops = 2.0 * model.n_active_params() * shape.global_batch * shape.seq_len
            else:  # decode
                args = (shard(_bf16_params(model.abstract_params()), model.param_specs()),
                        shard(inputs["caches"], input_spec["caches"]),
                        shard(inputs["token"], input_spec["token"]),
                        shard(inputs["pos"], input_spec["pos"]))
                step = model.serve_step_fn()
                model_flops = RL.decode_model_flops(model.n_active_params(), shape.global_batch)
            t_lower = time.time() - t0
            out, an = RL.analyze(step, *args)
            t_compile = time.time() - t0 - t_lower
        by_axis = an.collective_bytes_by_axis(mesh)
    finally:
        dist.destroy_process_group()

    # persist the trace's ops so roofline re-analysis never needs a rerun
    trace_path = out_dir / f"trace__{tag}__{arch}__{shape_name}__{mesh_name}.json.gz"
    with gzip.open(trace_path, "wt") as fh:
        json.dump(an.ops, fh)

    arg_ids = {id(t) for t in _leaves(args)}
    alias = sum(_local_bytes(t) for t in _leaves(out) if id(t) in arg_ids)
    arg_bytes, out_bytes = _local_bytes(args), _local_bytes(out)
    temp = an.temp_bytes
    per_dev_bytes = arg_bytes + out_bytes - alias + temp
    print(f"[{arch} × {shape_name} × {mesh_name}] MEMORY: arguments {arg_bytes} outputs {out_bytes} "
          f"aliased {alias} temporaries {temp} bytes a rank")
    print(f"[{arch} × {shape_name} × {mesh_name}] TRACE: flops={an.flops:.3e} bytes={an.traffic_bytes:.3e} "
          f"collective bytes={an.total_collective_bytes:.3e} ops={an.n_ops}")
    rl = RL.roofline_from_trace(an, model_flops=model_flops, n_chips=n_chips)
    rec.update(
        status="ok",
        n_chips=n_chips,
        n_params=model.n_params(),
        n_active_params=model.n_active_params(),
        lower_s=round(t_lower, 1),
        compile_s=round(t_compile, 1),
        memory={
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "temp_bytes": temp,
            # the largest temporaries live at the peak, by op and result
            "temp_at_peak": dict(list(an.temp_at_peak.items())[:8]),
            "per_device_total": per_dev_bytes,
            "fits_80G": bool(per_dev_bytes < DEVICE_BYTES),
        },
        roofline=rl.as_dict(),
        collective_bytes_by_axis=by_axis,
    )
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args()

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                mesh_name = "multi" if multi_pod else "single"
                path = out_dir / f"{args.tag}__{arch}__{shape}__{mesh_name}.json"
                if path.exists():
                    print(f"skip existing {path.name}")
                    continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, multi_pod, out_dir, tag=args.tag)
                except Exception as e:  # record failures, keep sweeping
                    failures += 1
                    rec = {
                        "arch": arch,
                        "shape": shape,
                        "mesh": mesh_name,
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-4000:],
                    }
                    print(f"[{arch} × {shape} × {mesh_name}] FAILED: {e}")
                rec["wall_s"] = round(time.time() - t0, 1)  # the cell's seconds on this host
                path.write_text(json.dumps(rec, indent=2))
                print(f"wrote {path.name} status={rec['status']} in {rec['wall_s']} s")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
