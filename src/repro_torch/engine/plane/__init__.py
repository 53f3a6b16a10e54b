"""Data-plane registry: named, memoized operator-execution backends.

The port keeps its own registry with two planes: ``numpy`` (the reference
semantics, host code) and ``torch`` (the relational CUDA kernel and device
join probe).  ``get_plane`` instantiates lazily and memoizes one instance
per ``(name, device)``: planes are stateless-per-run by contract (see
``base``), so one instance serves every run in the process.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.engine.plane.base import DataPlane, PlaneError


def _numpy_factory(device: str) -> DataPlane:
    from repro_torch.engine.plane.numpy_plane import NumpyPlane

    return NumpyPlane()


def _torch_factory(device: str) -> DataPlane:
    from repro_torch.engine.plane.torch_plane import TorchPlane

    return TorchPlane(device=device)


_REGISTRY: Dict[str, Callable[[str], DataPlane]] = {
    "numpy": _numpy_factory,
    "torch": _torch_factory,
}
_INSTANCES: Dict[Tuple[str, str], DataPlane] = {}


def available_planes() -> List[str]:
    """Registered plane names (cheap: does not instantiate backends)."""
    return sorted(_REGISTRY)


def get_plane(name: str, *, device: str = "cuda") -> DataPlane:
    """The memoized plane instance for ``name`` on ``device``.

    Raises ``PlaneError`` for unknown names, and for the ``torch`` plane on
    ``"cuda"`` when this host has no usable CUDA device.  The ``numpy``
    plane is host code and ignores ``device``.
    """
    factory = _REGISTRY.get(name)
    if factory is None:
        raise PlaneError(
            f"unknown plane {name!r}; available: {', '.join(available_planes())}"
        )
    key = (name, device)
    inst = _INSTANCES.get(key)
    if inst is None:
        inst = factory(device)
        _INSTANCES[key] = inst
    return inst


__all__ = ["DataPlane", "PlaneError", "available_planes", "get_plane"]
