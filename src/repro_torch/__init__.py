"""Veer's execution engine on PyTorch and CUDA, beside the JAX package.

The port runs a dataflow version, and a chain of versions with operator
reuse by content digest, on an NVIDIA GPU: the ``torch`` data plane puts
FILTER, PROJECT and predicate masks through a hand-written CUDA kernel
(``repro_torch.kernels.relational``) and the sparse JOIN probe on the
device.  It imports ``torch``, numpy and the standard library only; it keeps
its own copy of every module it needs from the reference package, under
the same relative path.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""

from repro_torch.engine import (
    DiskMaterializationStore,
    ExecutionPlan,
    InMemoryMaterializationStore,
    PlaneError,
    Table,
    execute,
    get_plane,
    tables_identical,
)

__all__ = [
    "DiskMaterializationStore",
    "ExecutionPlan",
    "InMemoryMaterializationStore",
    "PlaneError",
    "Table",
    "execute",
    "get_plane",
    "tables_identical",
]
