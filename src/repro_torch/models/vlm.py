"""VLM wrapper, internvl2 (the port of ``models/vlm.py``): a stub for the
ViT frontend, the projector, and the LM backbone of ``transformer.py``.

The caller supplies precomputed patch embeddings (B, n_patches, d_vision);
the projector maps them to d_model in bf16, and they go before the token
embeddings (early-fusion prefix).  The loss is taken on the text positions.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import PD, dense
from repro_torch.models.transformer import lm_loss, lm_param_defs

COMPUTE_DTYPE = torch.bfloat16


def vlm_param_defs(cfg: ArchConfig) -> Dict[str, Any]:
    defs = lm_param_defs(cfg)
    defs["vision_proj"] = PD((cfg.vision.d_vision, cfg.d_model), (None, "tp"))
    return defs


def project_patches(params: Dict[str, Any], patch_embeds: torch.Tensor) -> torch.Tensor:
    """(B, n_patches, d_vision) → the (B, n_patches, d_model) bf16 prefix."""
    return dense(patch_embeds.to(COMPUTE_DTYPE), params["vision_proj"])


def vlm_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
             attn_impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """batch: tokens (B, S + 1), patch_embeds (B, n_patches, d_vision).
    Differentiable (``vision_proj`` included)."""
    lm_batch = {"tokens": batch["tokens"],
                "prefix_embeds": project_patches(params, batch["patch_embeds"])}
    return lm_loss(params, lm_batch, cfg, attn_impl=attn_impl, remat=remat)
