"""Uniform model facade over all six families (the port of
``models/registry.py``): dense, SSM (Mamba-2), MoE, hybrid, audio
(whisper's encoder-decoder, ``models/encdec.py``) and VLM (internvl2,
``models/vlm.py``).

  model.init(seed, device="cuda")             real params on the device
  model.abstract_params()                     meta tensors (dry run, no alloc)
  model.param_specs()                         logical sharding spec tree
  model.input_specs(shape)                    (inputs as meta tensors, specs)
  model.forward(params, tokens)               logits (B, S, V), bf16
  model.forward_step(params, batch)           serve-side prefill compute
  model.loss(params, batch)                   mean next-token loss, fp32
  model.decode_step(params, caches, token, pos)

``attn_impl`` ("auto" | "cuda" | "reference", ``kernels/ops.py``) selects
the flash attention, SSD scan and RMSNorm implementation.  It defaults to
"auto": the hand-written kernels on CUDA tensors, whose autograd Functions
run the hand-written backward kernels of flash attention, RMSNorm and the
SSD scan.  The reference
defaults to its plain path; "reference" names the port's plain path.
``loss`` is differentiable; ``remat`` (default True, as the reference)
checkpoints each period of the stack.  ``forward``, ``forward_step`` and
``decode_step`` build no graph.

The specs are the reference's logical ones ("dp", "tp"): ``param_specs``
from each ``PD`` (with ``cfg.zero3_weights``, ``_apply_zero3`` adds a "dp"
shard to every big weight), ``input_specs`` for the batch or the decode
caches of a ``ShapeConfig``.  ``distributed/sharding.py`` binds them to a
``DeviceMesh``; under its ``mesh_context`` the same entry points run on
DTensors (``launch/dryrun.py``, and the mesh of one card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.models.layers import PD, abstract_tree, init_tree, spec_tree, tree_leaves, tree_map


FAMILIES = ("dense", "ssm", "moe", "hybrid", "audio", "vlm")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    instead of carrying on on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass
class Model:
    cfg: ArchConfig
    attn_impl: str = "auto"
    remat: bool = True

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"{self.cfg.name}: unknown family {self.cfg.family!r}; one of {FAMILIES}")
        if self.attn_impl not in IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; one of {IMPLS}")

    # -- params ---------------------------------------------------------------
    def param_defs(self):
        if self.cfg.family == "audio":
            defs = E.encdec_param_defs(self.cfg)
        elif self.cfg.family == "vlm":
            defs = V.vlm_param_defs(self.cfg)
        else:
            defs = T.lm_param_defs(self.cfg)
        if self.cfg.zero3_weights:
            defs = _apply_zero3(defs)
        return defs

    def init(self, seed: Union[int, torch.Generator] = 0, *, device="cuda"):
        """Parameters drawn from ``seed`` (or a ``torch.Generator`` on
        ``device``) on ``device``, fp32."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return init_tree(self.param_defs(), gen, dev)

    def abstract_params(self):
        return abstract_tree(self.param_defs())

    def param_specs(self):
        return spec_tree(self.param_defs())

    # -- inputs ---------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(inputs, specs)`` of a cell: meta tensors of the batch (train,
        prefill) or of the decode step's caches, token and position, and
        their logical specs."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            inputs = {"tokens": _meta((B, S + 1), torch.int32)}
            specs = {"tokens": ("dp", None)}
            if cfg.family == "vlm":
                inputs["patch_embeds"] = _meta((B, cfg.vision.n_patches, cfg.vision.d_vision), torch.bfloat16)
                specs["patch_embeds"] = ("dp", None, None)
            if cfg.family == "audio":
                inputs["frames"] = _meta((B, cfg.encoder.n_frames, cfg.encoder.d_frame), torch.bfloat16)
                specs["frames"] = ("dp", None, None)
            return inputs, specs
        # decode: one new token against a seq_len cache
        long_ctx = B < 16  # batch can't cover the dp axis — shard the sequence
        if cfg.family == "audio":
            shapes, cache_specs = E.encdec_cache_shapes(cfg, B, S), E.encdec_cache_specs(cfg, long_ctx)
        else:
            shapes, cache_specs = T.lm_cache_shapes(cfg, B, S), T.lm_cache_specs(cfg, long_ctx)
        inputs = {
            "caches": tree_map(lambda sd: _meta(*sd), shapes),
            "token": _meta((B,), torch.int32),
            "pos": _meta((), torch.int32),
        }
        specs = {
            "caches": cache_specs,
            "token": ("dp",) if not long_ctx else (None,),
            "pos": (),
        }
        return inputs, specs

    # -- steps ----------------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss (fp32 scalar) of ``batch["tokens"]`` (B, S + 1),
        with ``frames`` (audio) or ``patch_embeds`` (VLM); differentiable in
        ``params``."""
        kw = dict(attn_impl=self.attn_impl, remat=self.remat)
        if self.cfg.family == "audio":
            return E.encdec_loss(params, batch, self.cfg, **kw)
        if self.cfg.family == "vlm":
            return V.vlm_loss(params, batch, self.cfg, **kw)
        return T.lm_loss(params, batch, self.cfg, **kw)

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return T.lm_forward(params, tokens, self.cfg, attn_impl=self.attn_impl)

    @torch.no_grad()
    def forward_step(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Inference prefill: batch → logits (serve-side prefill compute).
        The VLM's logits cover the patches and the tokens."""
        tokens = batch["tokens"][:, :-1]
        if self.cfg.family == "audio":
            return E.encdec_forward(params, batch["frames"], tokens, self.cfg,
                                    attn_impl=self.attn_impl)
        prefix = None
        if self.cfg.family == "vlm":
            prefix = V.project_patches(params, batch["patch_embeds"])
        return T.lm_forward(params, tokens, self.cfg, attn_impl=self.attn_impl,
                            prefix_embeds=prefix)

    def decode_step(self, params, caches, token, pos):
        if self.cfg.family == "audio":
            return E.encdec_decode_step(params, caches, token, pos, self.cfg, impl=self.attn_impl)
        return T.lm_decode_step(params, caches, token, pos, self.cfg, impl=self.attn_impl)

    def serve_step_fn(self) -> Callable:
        def serve_step(params, caches, token, pos):
            return self.decode_step(params, caches, token, pos)

        return serve_step

    def loss_fn(self) -> Callable:
        def loss(params, batch):
            return self.loss(params, batch)

        return loss

    def n_params(self) -> int:
        total = 0
        for _, pd in tree_leaves(self.param_defs()):
            n = 1
            for s in pd.shape:
                n *= s
            total += n
        return total

    def n_active_params(self) -> int:
        """Active per token (MoE counts top_k of n_experts)."""
        if self.cfg.moe is None:
            return self.n_params()
        m = self.cfg.moe
        total = 0
        for path, pd in tree_leaves(self.param_defs()):
            n = 1
            for s in pd.shape:
                n *= s
            if "ffn_moe" in path and ("w_in" in path or "w_out" in path):
                n = n * m.top_k // m.n_experts
            total += n
        return total


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _apply_zero3(defs):
    """ZeRO-3-style: dp-shard every ≥2D weight on the first unsharded dim
    divisible by 32 (valid on both production meshes)."""

    def one(pd: PD) -> PD:
        if len(pd.shape) < 2:
            return pd
        axes = {a for s in pd.spec for a in ((s,) if isinstance(s, str) else (s or ()))}
        if "dp" in axes:
            return pd
        spec = list(pd.spec)
        for i, (ax, dim) in enumerate(zip(spec, pd.shape)):
            if ax is None and dim % 32 == 0 and dim >= 32:
                spec[i] = "dp"
                return PD(pd.shape, tuple(spec), pd.init, pd.scale, pd.dtype)
        return pd

    return tree_map(one, defs)


def build_model(cfg: ArchConfig, **kw) -> Model:
    return Model(cfg, **kw)
