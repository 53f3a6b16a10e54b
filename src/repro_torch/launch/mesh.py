"""Production meshes (the port of ``launch/mesh.py``, on ``DeviceMesh``).

Functions, not module constants: importing this module touches no process
group.  Single pod: (16, 16) ("data", "model") = 256 ranks.  Multi-pod:
(2, 16, 16) ("pod", "data", "model") = 512 ranks across 2 pods.  Each needs
an initialized default process group of the mesh's size, as the reference's
needs its forced host devices: the card's own for a real mesh (``nccl``), a
fake one for the dry run (``launch/dryrun.py``).  A real mesh lives on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations


def _make_mesh(shape, axes, device: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh {shape} needs an initialized default process group of {n} ranks")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh {shape} needs {n} ranks; the process group has {dist.get_world_size()}")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *, multi_pod: bool = False, device: str = "cuda"):
    """Small mesh for CI-sized sharding tests, and the mesh of one card."""
    if multi_pod:
        return _make_mesh((2, n_data, n_model), ("pod", "data", "model"), device)
    return _make_mesh((n_data, n_model), ("data", "model"), device)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}``, as the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_total(mesh) -> int:
    shape = mesh_shape(mesh)
    n = shape.get("data", 1)
    if "pod" in shape:
        n *= shape["pod"]
    return n
