"""Mixture-of-Experts block — GShard-style capacity dispatch (the port of
``models/moe.py``).

Each batch row is a dispatch group with capacity ``C = max(K, int(S·K·cf/E))``
slots per expert.  The router runs in fp32; the expert matmuls in the
activations' bf16, the fp32 weights cast per call as the reference casts
them.  ``rms_norm`` goes through ``ops.rmsnorm``, so on the card the MoE's
``ln`` runs the hand-written RMSNorm kernel.

Two points where a literal translation would route differently from the
reference, and what this module does about each:

  * **Tie-breaking.**  ``jax.lax.top_k`` takes the lower expert index among
    equal probabilities; ``torch.topk`` leaves the order open.  ``route``
    sorts stably in descending order and keeps the first K.
  * **Dispatch order.**  Assignments are ranked within an expert in
    token-major order (token s, then its k-th choice): the reference's
    ``onehot.reshape(B, S*K, E)``.  ``keep = pos_in_expert < C`` drops the
    later ones in that order.  The reference's ``.at[...].set(mode="drop")``
    scatter of the slot ``C`` has no torch counterpart, so the gather path
    scatters into ``C + 1`` slots and slices the last off, as the einsum
    path does with its one-hot.

On a mesh the block is expert-parallel (``_moe_on_mesh``): each "model"
rank computes its own experts' slots of every row it routes, and one
all-reduce over "model" sums their outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import even, on_local_shards, row_placements, shard_offset
from repro_torch.models.layers import PD, rms_norm, silu, whole_rows

DISPATCHES = ("gather", "einsum")


def moe_defs(cfg: ArchConfig) -> Dict[str, PD]:
    d = cfg.d_model
    m = cfg.moe
    return {
        "ln": PD((d,), (None,), init="ones"),
        "w_gate": PD((d, m.n_experts), (None, None)),
        "w_in": PD((m.n_experts, d, 2 * m.d_ff_expert), ("tp", None, "dp")),
        "w_out": PD((m.n_experts, m.d_ff_expert, d), ("tp", "dp", None)),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.long) -> torch.Tensor:
    """``F.one_hot`` without its range check, which reads the indices back
    to the host and so stalls a decode loop on the card every layer."""
    return torch.zeros(idx.shape + (n,), dtype=dtype, device=idx.device).scatter_(
        -1, idx.unsqueeze(-1), 1)


def capacity(cfg: ArchConfig, S: int, capacity_factor: Optional[float] = None) -> int:
    """Slots per expert for a group of ``S`` tokens."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    return max(m.top_k, int(S * m.top_k * cf / m.n_experts))


def route(
    h: torch.Tensor, w_gate: torch.Tensor, K: int, C: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on normalized activations ``h`` (B, S, d): ``(gate_vals,
    gate_idx, pos_in_expert, keep)``, each (B, S, K).  ``gate_vals`` are the
    top-K softmax probabilities (fp32) renormalized over the K; ``pos_in_expert``
    ranks each assignment within its expert in token-major order; ``keep``
    marks the assignments that fit in ``C`` slots."""
    B, S, _ = h.shape
    E = w_gate.shape[-1]
    logits = torch.matmul(h.to(torch.float32), w_gate.to(torch.float32))  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: among equal probabilities the lower index first
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat = _one_hot(gate_idx, E).reshape(B, S * K, E)
    ranks = torch.cumsum(flat, dim=1) - flat
    pos_in_expert = (ranks * flat).sum(-1).reshape(B, S, K)
    keep = pos_in_expert < C
    return gate_vals, gate_idx, pos_in_expert, keep


def _experts(expert_in: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its slots: (B, E, C, d) -> (B, E, C, d)."""
    B, E, C, d = expert_in.shape
    dt = expert_in.dtype
    xe = expert_in.transpose(0, 1).reshape(E, B * C, d)
    gate, up = torch.chunk(torch.bmm(xe, w_in.to(dt)), 2, dim=-1)
    out = torch.bmm(silu(gate) * up, w_out.to(dt))                       # (E, B*C, d)
    return out.reshape(E, B, C, d).transpose(0, 1)


def _moe_on_mesh(p, x, cfg: ArchConfig, **kw) -> torch.Tensor:
    """``moe_block`` on a mesh, expert-parallel as the reference's compiled
    program lays it out.  Each rank runs ``local`` on its own rows, whole
    (``layers.whole_rows``), through ``local_map`` (the routing's top-k,
    one-hot and scatter have no DTensor rules):

      * it keeps the experts its "model" shard of ``w_in`` / ``w_out``
        holds (``moe_defs``' "tp"), their weights gathered over "data" (and
        "pod") only;
      * it routes its rows over all E experts exactly as without a mesh
        (the same capacity, ``keep`` and slots), and computes the slots of
        its own experts; assignments to the others add nothing here;
      * its output, in the activations' dtype, is a partial sum over
        "model" (``Partial``), which one all-reduce over "model" completes.

    The local experts' weight gradients stay split over "model" and are
    partial sums over "data"; the router's and the norm's are partial sums
    over both (``on_local_shards``' rule).  Where the "model" ranks do not
    divide E evenly, every rank gathers every expert's weights and computes
    them all, as the run without "model" ranks would: the block's output is
    the same, at E times the expert weights a rank.  On a mesh of one rank
    the shard is every expert, and the block is bit for bit the run without
    a mesh."""
    mesh = x.device_mesh
    m = list(mesh.mesh_dim_names).index("model")
    E = cfg.moe.n_experts
    ep = even(E, "tp", mesh) is not None
    x = whole_rows(x)
    rows = list(row_placements(x))
    rows[m] = Replicate()  # every "model" rank routes the same rows
    if list(x.placements) != rows:
        x = x.redistribute(mesh, rows)
    out = list(rows)
    if ep:
        out[m] = Partial()
    lo = shard_offset(mesh, [(m, mesh.size(m))], E) if ep else 0
    experts = "tp" if ep else None
    specs = {"ln": (None,), "w_gate": (None, None), "w_in": (experts, None, None),
             "w_out": (experts, None, None)}
    keys = sorted(p)

    def local(x, *ws):
        return _experts_output(dict(zip(keys, ws)), x, cfg, lo=lo, **kw).to(x.dtype)

    y = on_local_shards(local, (x, *(p[k] for k in keys)), (rows, *(specs[k] for k in keys)), (out,))
    return x + y.redistribute(mesh, rows)


def _experts_output(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    capacity_factor: Optional[float] = None,
    dispatch: str = "gather",
    impl: str = "auto",
    lo: int = 0,
) -> torch.Tensor:
    """The experts' combined output (B, S, d) in fp32, from the experts
    ``lo`` .. ``lo + n`` that ``p``'s ``n`` rows of ``w_in`` / ``w_out``
    hold (all E without a mesh).  Routing is over all E experts."""
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    El = p["w_in"].shape[0]
    C = capacity(cfg, S, capacity_factor)

    h = rms_norm(x, p["ln"], cfg.rms_eps, impl=impl)                      # (B, S, d)
    gate_vals, gate_idx, pos_in_expert, keep = route(h, p["w_gate"], K, C)
    if El != E:
        # another rank's expert: dropped here (slot C, weight 0), as an
        # assignment past capacity is
        mine = (gate_idx >= lo) & (gate_idx < lo + El)
        keep = keep & mine
        gate_idx = torch.where(mine, gate_idx - lo, 0)
    slot = torch.where(keep, pos_in_expert, C)                           # C: dropped
    if dispatch == "einsum":
        slot_oh = _one_hot(slot, C + 1, h.dtype)[..., :C]                # (B, S, K, C)
        eoh = _one_hot(gate_idx, El, h.dtype)                            # (B, S, K, El)
        disp = torch.einsum("bske,bskc->bsec", eoh, slot_oh)             # (B, S, El, C)
        w = (gate_vals.to(h.dtype) * keep.to(h.dtype))[..., None]
        comb = torch.einsum("bske,bskc->bsec", eoh * w, slot_oh)
        expert_in = torch.einsum("bsec,bsd->becd", disp, h)              # (B, El, C, d)
    else:
        # slot_token[b, e, c] = the token in slot (e, c), or S (the zero pad)
        slot_token = torch.full((B, El, C + 1), S, dtype=torch.long, device=x.device)
        b_idx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
        s_idx = torch.arange(S, device=x.device)[None, :, None].expand(B, S, K)
        slot_token[b_idx, gate_idx, slot] = s_idx
        slot_token = slot_token[..., :C].reshape(B, El * C, 1)
        h_pad = torch.cat([h, torch.zeros((B, 1, d), dtype=h.dtype, device=h.device)], dim=1)
        expert_in = torch.gather(h_pad, 1, slot_token.expand(B, El * C, d)).reshape(B, El, C, d)
    expert_out = _experts(expert_in, p["w_in"], p["w_out"])
    # the combines sum the bf16 products in fp32 and round once, as the
    # reference's bf16 einsums do
    if dispatch == "einsum":
        return torch.einsum("bsec,becd->bsd", comb.float(), expert_out.float())
    flat_out = expert_out.reshape(B, El * C, d)
    tok_slot = gate_idx * C + torch.where(keep, pos_in_expert, 0)         # (B, S, K)
    gathered = torch.gather(flat_out, 1, tok_slot.reshape(B, S * K, 1).expand(B, S * K, d))
    w = (gate_vals * keep.to(gate_vals.dtype)).to(h.dtype)
    return torch.einsum("bskd,bsk->bsd", gathered.reshape(B, S, K, d).float(), w.float())


def moe_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    *,
    capacity_factor: Optional[float] = None,
    dispatch: str = "gather",   # "gather" (sparse, O(T·d)) | "einsum" (GShard)
    impl: str = "auto",
) -> torch.Tensor:
    """``x`` plus the experts' output, each token to its top-K experts with
    a slot to spare (the rest dropped: they add nothing)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}; one of {DISPATCHES}")
    if isinstance(x, DTensor):
        return _moe_on_mesh(p, x, cfg, capacity_factor=capacity_factor, dispatch=dispatch, impl=impl)
    y = _experts_output(p, x, cfg, capacity_factor=capacity_factor, dispatch=dispatch, impl=impl)
    return x + y.to(x.dtype)
