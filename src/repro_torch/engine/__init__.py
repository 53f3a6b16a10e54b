from repro_torch.engine.table import Table, tables_equal, tables_identical
from repro_torch.engine.executor import (
    ExecResult,
    ExecStats,
    ExecutionPlan,
    execute,
    sink_results_equal,
)
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
    "tables_equal",
    "tables_identical",
    "ExecResult",
    "ExecStats",
    "ExecutionPlan",
    "execute",
    "sink_results_equal",
    "DiskMaterializationStore",
    "InMemoryMaterializationStore",
    "MaterializationStore",
    "table_digest",
    "register_udf",
    "register_nonlinear",
    "UDF_REGISTRY",
]
