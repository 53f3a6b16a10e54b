"""Mamba-2 block (SSD mixer): prefill (chunked SSD) + single-token decode
(the port of ``models/ssm.py``).

The SSD inner scan goes through ``kernels/ops.py::ssd`` (the hand-written
kernel on CUDA tensors, the chunked plain version on the host, or by name);
``ssd_impl`` selects it and the RMSNorm implementation alike.  Decode carries
(conv buffer, SSM state) and runs the plain ``ssd_decode_step``, as the
reference does; the caches are updated in place (the reference returns new
ones) and returned.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import PD, dense, rms_norm, silu, whole_rows


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    return s, d_inner, H, conv_dim, d_in_proj


def mamba_defs(cfg: ArchConfig) -> Dict[str, PD]:
    """Split (not fused) projections, as in the reference, whose tp-sharded
    layout they keep as documentation."""
    s, d_inner, H, conv_dim, d_in_proj = _dims(cfg)
    d = cfg.d_model
    gn_axis = "tp" if (s.n_groups * s.d_state) % 16 == 0 else None
    return {
        "ln": PD((d,), (None,), init="ones"),
        "z_proj": PD((d, d_inner), (None, "tp")),
        "x_proj": PD((d, d_inner), (None, "tp")),
        "b_proj": PD((d, s.n_groups * s.d_state), (None, gn_axis)),
        "c_proj": PD((d, s.n_groups * s.d_state), (None, gn_axis)),
        "dt_proj": PD((d, H), (None, "tp")),
        "conv_x_w": PD((s.d_conv, d_inner), (None, "tp"), scale=0.1),
        "conv_x_b": PD((d_inner,), ("tp",), init="zeros"),
        "conv_b_w": PD((s.d_conv, s.n_groups * s.d_state), (None, gn_axis), scale=0.1),
        "conv_b_b": PD((s.n_groups * s.d_state,), (gn_axis,), init="zeros"),
        "conv_c_w": PD((s.d_conv, s.n_groups * s.d_state), (None, gn_axis), scale=0.1),
        "conv_c_b": PD((s.n_groups * s.d_state,), (gn_axis,), init="zeros"),
        "A_log": PD((H,), ("tp",), init="zeros"),
        "D": PD((H,), ("tp",), init="ones"),
        "dt_bias": PD((H,), ("tp",), init="zeros"),
        "gn": PD((d_inner,), ("tp",), init="ones"),
        "out_proj": PD((d_inner, d), ("tp", None)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` everywhere
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis + SiLU, in x's dtype: the
    taps summed in order, each product and add rounded, as the reference's
    Python ``sum`` does."""
    S = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, d_conv - 1, 0))
    out = pad[:, 0:S, :] * w[0].to(x.dtype)
    for i in range(1, d_conv):
        out = out + pad[:, i:i + S, :] * w[i].to(x.dtype)
    return silu(out + b.to(x.dtype))


def _split_xbc(xBC: torch.Tensor, cfg: ArchConfig):
    s, d_inner, H, _, _ = _dims(cfg)
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + s.n_groups * s.d_state]
    Cm = xBC[..., d_inner + s.n_groups * s.d_state:]
    return x, Bm, Cm


def mamba_block(
    p: Dict[str, torch.Tensor],
    x_in: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    *,
    ssd_impl: str = "auto",
) -> torch.Tensor:
    s, d_inner, H, conv_dim, _ = _dims(cfg)
    B, S, d = x_in.shape
    x_in = whole_rows(x_in)
    h = rms_norm(x_in, p["ln"], cfg.rms_eps, impl=ssd_impl)
    z = dense(h, p["z_proj"])
    xs = _causal_conv(dense(h, p["x_proj"]), p["conv_x_w"], p["conv_x_b"], s.d_conv)
    Bm = _causal_conv(dense(h, p["b_proj"]), p["conv_b_w"], p["conv_b_b"], s.d_conv)
    Cm = _causal_conv(dense(h, p["c_proj"]), p["conv_c_w"], p["conv_c_b"], s.d_conv)
    dt = dense(h, p["dt_proj"])

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, S, H, s.head_dim)
    Bh = Bm.reshape(B, S, s.n_groups, s.d_state)
    Ch = Cm.reshape(B, S, s.n_groups, s.d_state)
    chunk = min(s.chunk, S)
    y, _ = kops.ssd(xh, dt, A, Bh, Ch, chunk=chunk, impl=ssd_impl)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner).to(x_in.dtype)
    y = rms_norm(y * silu(z), p["gn"], cfg.rms_eps, impl=ssd_impl)
    return x_in + dense(y, p["out_proj"])


# ---------------------------------------------------------------------------
# Decode (constant-size state)
# ---------------------------------------------------------------------------


def mamba_cache_shape(cfg: ArchConfig, batch: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    s, d_inner, H, conv_dim, _ = _dims(cfg)
    return {
        "conv": ((batch, s.d_conv - 1, conv_dim), torch.bfloat16),
        "ssm": ((batch, H, s.head_dim, s.d_state), torch.float32),
    }


def mamba_cache_spec(long_context: bool) -> Dict[str, Tuple]:
    """The caches' logical sharding: state is seq-independent; heads/channels
    over tp, batch over dp (long-context decode has batch=1 — batch
    unsharded there)."""
    if long_context:
        return {"conv": (None, None, "tp"), "ssm": (None, "tp", None, None)}
    return {
        "conv": ("dp", None, "tp"),
        "ssm": ("dp", "tp", None, None),
    }


def mamba_decode_block(
    p: Dict[str, torch.Tensor],
    x_in: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],
    pos,
    cfg: ArchConfig,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through the block; ``pos`` is unused (the state carries the
    position), as in the reference.  The cache is updated in place and
    returned."""
    s, d_inner, H, conv_dim, _ = _dims(cfg)
    B = x_in.shape[0]
    h = rms_norm(x_in, p["ln"], cfg.rms_eps, impl=impl)
    z = dense(h, p["z_proj"])[:, 0]
    xBC = torch.cat(
        [dense(h, p["x_proj"]), dense(h, p["b_proj"]), dense(h, p["c_proj"])], dim=-1
    )[:, 0]
    dt = dense(h, p["dt_proj"])[:, 0]
    conv_w = torch.cat([p["conv_x_w"], p["conv_b_w"], p["conv_c_w"]], dim=1)
    conv_bias = torch.cat([p["conv_x_b"], p["conv_b_b"], p["conv_c_b"]])

    conv_buf = cache["conv"]  # (B, d_conv-1, conv_dim)
    full = torch.cat([conv_buf.to(xBC.dtype), xBC[:, None, :]], dim=1)
    # the reference's einsum over the taps: exact products of bf16 values,
    # summed in fp32 and rounded once
    conv = (full.float() * conv_w.to(xBC.dtype).float()[None]).sum(dim=1).to(xBC.dtype)
    xBC1 = silu(conv + conv_bias.to(xBC.dtype))
    conv_buf.copy_(full[:, 1:, :])

    xs, Bm, Cm = _split_xbc(xBC1, cfg)
    dtv = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, new_state = kref.ssd_decode_step(
        cache["ssm"],
        xs.reshape(B, H, s.head_dim),
        dtv,
        A,
        Bm.reshape(B, s.n_groups, s.d_state),
        Cm.reshape(B, s.n_groups, s.d_state),
    )
    cache["ssm"].copy_(new_state)
    y = y + p["D"].float()[None, :, None] * xs.reshape(B, H, s.head_dim).float()
    y = y.reshape(B, d_inner).to(x_in.dtype)
    y = rms_norm(y * silu(z), p["gn"], cfg.rms_eps, impl=impl)
    out = x_in + dense(y[:, None, :], p["out_proj"])
    return out, cache
