"""Distributed runtime pieces of the port.  Only the fault-tolerance pieces
are ported so far; the sharding helpers (``constrain``, the logical to
physical spec maps) come with the mesh (ROADMAP queue 1, item 5)."""

from repro_torch.distributed.fault import ElasticPlan, FailureInjector, InjectedFailure, StragglerMonitor

__all__ = ["ElasticPlan", "FailureInjector", "InjectedFailure", "StragglerMonitor"]
