"""Distributed runtime pieces of the port: the fault-tolerance pieces
(``fault.py``) and the sharding helpers (``sharding.py``: the logical to
physical spec maps, DTensor placements, ``mesh_context`` and
``constrain``).  The meshes themselves are built in ``launch/mesh.py``."""

from repro_torch.distributed.fault import ElasticPlan, FailureInjector, InjectedFailure, StragglerMonitor
from repro_torch.distributed.sharding import (Sharding, constrain, local_tree, logical_to_physical,
                                              mesh_context, placements, shard_tree, spec_tree_to_shardings)

__all__ = ["ElasticPlan", "FailureInjector", "InjectedFailure", "Sharding", "StragglerMonitor", "constrain",
           "local_tree", "logical_to_physical", "mesh_context", "placements", "shard_tree",
           "spec_tree_to_shardings"]
