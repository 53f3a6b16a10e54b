"""Carry a dataflow and its data across from the reference package.

``from_reference(dag_dict, tables)`` takes what the reference package's
``api.serialize.dag_to_dict(dag)`` returns (plain JSON-able data) and the
source tables as numpy columns, and returns the port's ``DataflowDAG`` and
``Table``s.  The two packages share the DAG codec, so the carried DAG has
the same operator signatures and content digests, and the same dataflow
runs on the same data in both.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from repro_torch.core.dag import DataflowDAG
from repro_torch.core.serialize import dag_from_dict
from repro_torch.engine.table import Table


def from_reference(
    dag_dict: Mapping, tables: Mapping[str, Mapping[str, np.ndarray]]
) -> Tuple[DataflowDAG, Dict[str, Table]]:
    """``(dag, {source id: Table})``; each table's columns keep the order
    of the mapping they came in."""
    dag = dag_from_dict(dict(dag_dict))
    return dag, {sid: Table(dict(cols), list(cols)) for sid, cols in tables.items()}
