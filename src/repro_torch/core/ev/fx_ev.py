"""FxEV — the traced equivalence verifier, on ``torch.fx``.

Lowers each window sub-DAG to a ``torch.fx`` graph over symbolic
``(cols, mask)`` tables (``make_fx`` over float32 and bool tensors of
``_SYMBOLIC_ROWS`` rows on the CPU) and compares the graphs' canonical code
text.  Sound: identical graphs with aligned inputs denote identical
computations, and every registered body is a faithful model of the engine
op (all semantics-bearing properties are folded into the trace as Python
scalars, whose values the code prints).  A graph that reads a tensor
captured from outside the trace (a ``get_attr`` node) prints that tensor
only by name, so such a window is answered ``None``.  Incomplete
(syntactic), never proves inequivalence.

It is the port's counterpart of the reference package's JAX-traced EV
(``core/ev/jaxpr_ev.py``) and is registered under the same name,
``"jaxpr"``: the name is on the wire in ``VeerConfig.evs``, in
``Certificate.to_json()``, in the learned guidance's per-EV scorers and in
its ``cap_*_jaxpr`` features, so a config, a certificate or a model written
by either package reads in the other.

Tracing is host work and never touches CUDA: verification runs on the
host, also in a fleet's worker processes.  The graph text holds no ids or
addresses, so the same window gives the same text in every process.

Restrictions: every operator traceable (see ``torch_bodies.TRACEABLE_OPS``),
numeric predicates only.  Restriction-monotonic: adding an untraceable op to
any window keeps it invalid.

Supported fragment (format shared by all EVs; see docs/ARCHITECTURE.md):

    ============== ==========================================================
    EV             FxEV (``jaxpr``)
    Operators      every op with a registered torch body
                   (``torch_bodies.TRACEABLE_OPS`` — relational core + UDF /
                   Classifier / Sentiment with numeric models)
    Semantics      set, bag, ordered
    Restrictions   J1 all operators have registered torch bodies; J2 numeric
                   columns / predicates only
    Monotonic      yes
    Proves inequiv no — syntactic graph comparison, True or Unknown only
    ============== ==========================================================
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core import dag as D
from repro_torch.core.dag import BAG, ORDERED, SET, DataflowDAG, infer_schema
from repro_torch.core.ev import torch_bodies as B
from repro_torch.core.ev.base import BaseEV, QueryPair, Restriction

_SYMBOLIC_ROWS = 8  # capacity of symbolic tables; bodies are shape-generic

# make_fx keeps its tracer state in module globals: one trace at a time
_TRACE_LOCK = threading.Lock()


class FxEV(BaseEV):
    name = "jaxpr"
    semantics = frozenset({SET, BAG, ORDERED})
    restriction_monotonic = True
    can_prove_inequivalence = False
    supported_op_types = B.TRACEABLE_OPS

    def restrictions(self) -> List[Restriction]:
        return [
            Restriction("J1", "all operators have registered torch bodies"),
            Restriction("J2", "numeric columns / predicates only"),
        ]

    def failed_restrictions(self, qp: QueryPair) -> List[str]:
        failed = []
        for dag in (qp.P, qp.Q):
            for op in dag.ops.values():
                if op.op_type not in B.TRACEABLE_OPS:
                    failed.append("J1")
                elif not B.op_traceable(op):
                    failed.append("J2")
        return sorted(set(failed))

    def validate(self, qp: QueryPair) -> bool:
        return not self.failed_restrictions(qp)

    def check(self, qp: QueryPair) -> Optional[bool]:
        try:
            # result tables carry column names: sink schemas must agree too
            sp = infer_schema(qp.P, {})
            sq = infer_schema(qp.Q, {})
            for p, q in qp.sink_pairs:
                if sp[p] != sq[q]:
                    return None
            ga = _window_graph(qp.P, [p for p, _ in qp.sink_pairs])
            gb = _window_graph(qp.Q, [q for _, q in qp.sink_pairs])
        except (B.TraceUnsupported, KeyError, TypeError, RuntimeError, D.DAGError):
            return None
        if ga is None or gb is None:
            return None
        return True if ga == gb else None


def _window_graph(dag: DataflowDAG, sinks: List[str]) -> Optional[str]:
    """Canonical graph code of the sub-DAG as fn(source tables)->sink tables,
    or ``None`` when the graph reads a captured tensor.

    Inputs are ordered by source id (shared between P and Q by construction
    of the QueryPair), outputs by the sink order given; each output is the
    sink's columns in schema order plus its mask — so column naming is
    erased and only computation structure remains.
    """
    src_ids = sorted(dag.sources)
    schemas = infer_schema(dag, {})

    def fn(*arrays):
        # unpack: one (cols..., mask) group per source
        tables: Dict[str, B.TTable] = {}
        k = 0
        for sid in src_ids:
            sch = schemas[sid]
            cols = {c: arrays[k + i] for i, c in enumerate(sch)}
            mask = arrays[k + len(sch)]
            tables[sid] = (cols, mask)
            k += len(sch) + 1
        results: Dict[str, B.TTable] = {}
        for op_id in dag.topo_order():
            op = dag.ops[op_id]
            if op.op_type == D.SOURCE:
                results[op_id] = tables[op_id]
                continue
            ins = [results[l.src] for l in dag.in_links[op_id]]
            results[op_id] = B.execute_op_torch(op, ins)
        out = []
        for s in sinks:
            cols, mask = results[s]
            for c in schemas[s]:
                out.append(cols[c])
            out.append(mask)
        return tuple(out)

    args = []
    for sid in src_ids:
        for _ in schemas[sid]:
            args.append(torch.zeros(_SYMBOLIC_ROWS, dtype=torch.float32))
        args.append(torch.zeros(_SYMBOLIC_ROWS, dtype=torch.bool))
    with _TRACE_LOCK:
        gm = make_fx(fn)(*args)
    if any(node.op == "get_attr" for node in gm.graph.nodes):
        return None
    return gm.code
