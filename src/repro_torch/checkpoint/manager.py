"""Fault-tolerant checkpointing with content-hash dedup (the port of
``checkpoint/manager.py``).

  * **Atomic**: writes go to ``step_XXXXXXXX.tmp/`` and are renamed into
    place — a crash mid-write can never corrupt the latest checkpoint.
  * **Async**: the device→host copy happens synchronously (a consistent
    snapshot, even though the optimizer updates the tensors in place
    afterwards), the disk write on a writer thread so the loop keeps
    stepping.
  * **Content-hash dedup** (paper Use case 2): each array file is named by
    its content hash in a shared object store; checkpoints reference
    objects, so consecutive checkpoints share unchanged tensors, and
    Veer-verified equivalent pipeline versions share materialized results.

The layout is the reference's, byte for byte: leaves are named as its
``_tree_flatten_with_names`` names them (sorted dict keys and sequence
indices joined by "/"), each object is ``np.save`` of the leaf as a numpy
array under ``sha256(bytes + str(dtype) + str(shape))[:32]``, and
``index.json`` maps names to ``{"object", "shape", "dtype"}``.  So for the
same state the two packages write the same ``index.json`` and object files,
and each restores the other's checkpoints.  ``meta.json``'s ``"treedef"``
describes the tree in the port's own words (the reference writes JAX's).
A leaf whose dtype numpy lacks (bf16) raises.  A DTensor leaf is saved as
the full tensor it stands for.  ``restore(..., shardings=)`` re-shards each
restored leaf onto the current mesh as a DTensor (elastic restart):
``shardings`` is a tree like ``like`` of ``distributed.sharding.Sharding``
(``spec_tree_to_shardings``), or None at a leaf to restore it plain.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _named_leaves(tree, prefix: str = "", is_leaf=None) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in the reference's order: dict keys sorted, tuple and
    list items by index (a node for which ``is_leaf`` holds is a leaf)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_named_leaves(v, f"{prefix}/{k}" if prefix else k, is_leaf))
    return out


def _structure(tree) -> str:
    """The tree's shape with every leaf as ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves, f"{prefix}/{k}" if prefix else str(k)) for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _host(name: str, leaf) -> np.ndarray:
    """A host copy of ``leaf`` as a C-contiguous numpy array."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"checkpoint leaf {name!r} is bf16, which numpy cannot hold")
        return leaf.detach().to("cpu", copy=True).contiguous().numpy()
    return np.array(leaf, copy=True, order="C")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.objects = self.dir / "objects"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.objects.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._writer: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, metadata: Optional[Dict] = None) -> None:
        # copy to the host synchronously (a consistent snapshot)
        host = [(name, _host(name, leaf)) for name, leaf in _named_leaves(state)]
        meta = dict(metadata or {})
        meta["step"] = step
        meta["treedef"] = _structure(state)

        def write():
            with self._lock:
                self._write_snapshot(step, host, meta)

        self.wait()
        if self.async_write:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()
        else:
            write()

    def _write_snapshot(self, step, host, meta):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        index = {}
        for name, arr in host:
            digest = hashlib.sha256(arr.tobytes() + str(arr.dtype).encode() + str(arr.shape).encode()).hexdigest()[:32]
            obj = self.objects / f"{digest}.npy"
            if not obj.exists():  # dedup: shared unchanged tensors
                fd, tmpname = tempfile.mkstemp(dir=self.objects)
                os.close(fd)
                np.save(tmpname, arr, allow_pickle=False)
                os.replace(tmpname + ".npy" if os.path.exists(tmpname + ".npy") else tmpname, obj)
                if os.path.exists(tmpname):
                    os.unlink(tmpname)
            index[name] = {
                "object": digest,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        (tmp / "index.json").write_text(json.dumps(index))
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        # object GC: drop unreferenced objects
        referenced = set()
        for s in self.all_steps():
            idx = self.dir / f"step_{s:08d}" / "index.json"
            if idx.exists():
                for rec in json.loads(idx.read_text()).values():
                    referenced.add(rec["object"])
        for obj in self.objects.glob("*.npy"):
            if obj.stem not in referenced:
                obj.unlink(missing_ok=True)

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    # -- restore ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "index.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest published step, once this manager's pending write (an
        asynchronous save) has landed: a restart in the same process sees
        the checkpoint it saved last (the reference's does not wait, and
        with ``async_write=True`` can miss it)."""
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any, *, shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like``: every leaf a tensor on the
        device of ``like``'s leaf of the same name, in the stored dtype; with
        ``shardings``, each leaf that has a ``Sharding`` there is distributed
        over its mesh by its placements instead (a DTensor on the mesh's
        device)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        snap = self.dir / f"step_{step:08d}"
        index = json.loads((snap / "index.json").read_text())
        meta = json.loads((snap / "meta.json").read_text())
        shard = {}
        if shardings is not None:
            from repro_torch.distributed.sharding import Sharding

            shard = dict(_named_leaves(shardings, is_leaf=lambda x: isinstance(x, Sharding)))
        leaves = {}
        for name, ref_leaf in _named_leaves(like):
            arr = torch.from_numpy(np.load(self.objects / f"{index[name]['object']}.npy"))
            shd = shard.get(name)
            if shd is not None:
                from torch.distributed.tensor import distribute_tensor

                leaves[name] = distribute_tensor(arr.to(shd.mesh.device_type), shd.mesh, list(shd.placements))
            else:
                device = ref_leaf.device if isinstance(ref_leaf, torch.Tensor) else "cpu"
                leaves[name] = arr.to(device)
        return _rebuild(like, leaves), meta
