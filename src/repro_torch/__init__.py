"""Veer on PyTorch and CUDA, beside the JAX package.

The port runs a dataflow version, and a chain of versions with operator
reuse by content digest, on an NVIDIA GPU: the ``torch`` data plane puts
FILTER, PROJECT and predicate masks through a hand-written CUDA kernel
(``repro_torch.kernels.relational``) and the sparse JOIN probe on the
device.  It verifies a version pair as the reference package does
(``repro_torch.api.verify``: Algorithm 2 with the Equitas, Spes, UDP and
traced EVs, optionally steered by the learned guidance of ``learn``, and a
replayable certificate), and ``engine.sink_results_equal`` checks a verdict
by running both versions.  ``service.VersionChainSession`` runs a version
chain: each pair verified, and each version executed in full, with
certificate-backed reuse, or as a row delta through the edited cone;
``service.VerificationService`` (threads) and
``service.VerificationFleet`` (worker processes over a shared cache tier)
serve many such chains, and ``workload`` generates and replays edit
sessions against them.  It imports ``torch``, numpy and the
standard library only; it keeps its own copy of every module it needs
from the reference package, under the same relative path.  Entry points
run on ``"cuda"`` unless the caller passes ``device="cpu"``.
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
