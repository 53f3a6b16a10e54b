from repro_torch.engine.table import Table, tables_identical
from repro_torch.engine.executor import ExecResult, ExecStats, ExecutionPlan, execute
from repro_torch.engine.store import (
    DiskMaterializationStore,
    InMemoryMaterializationStore,
    MaterializationStore,
    table_digest,
)
from repro_torch.engine.ops_impl import register_udf, register_nonlinear, UDF_REGISTRY
from repro_torch.engine.plane import DataPlane, PlaneError, available_planes, get_plane

__all__ = [
    "DataPlane",
    "PlaneError",
    "available_planes",
    "get_plane",
    "Table",
    "tables_identical",
    "ExecResult",
    "ExecStats",
    "ExecutionPlan",
    "execute",
    "DiskMaterializationStore",
    "InMemoryMaterializationStore",
    "MaterializationStore",
    "table_digest",
    "register_udf",
    "register_nonlinear",
    "UDF_REGISTRY",
]
