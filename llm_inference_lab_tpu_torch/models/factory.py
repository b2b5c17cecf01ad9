"""Shared model-family factory (port of llm_inference_lab_tpu/models/
factory.py): a preset config and random init from a seed, or given params.
Loading a checkpoint comes with a later slice."""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

import torch

from llm_inference_lab_tpu_torch.models import transformer
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig


def create_family_model(configs: Dict[str, ModelConfig], name: str, *, device,
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        quantized_init: Optional[str] = None, quantize_embed: bool = False,
                        params: Optional[dict] = None) -> Model:
    """configs[name] on `device`: the given params, or a random init from a
    torch.Generator seeded with `seed` (directly in quantized form when
    quantized_init is "int4"/"int8")."""
    cfg = replace(configs[name], dtype=dtype)
    if params is None:
        g = torch.Generator(device=device).manual_seed(seed)
        if quantized_init:
            params = transformer.init_params_quantized(
                cfg, g, device, mode=quantized_init, quantize_embed=quantize_embed)
        else:
            params = transformer.init_params(cfg, g, device)
    return Model(config=cfg, params=params)
