"""Shared model-family factory (port of llm_inference_lab_tpu/models/
factory.py): a preset config, and weights in JAX's order of preference:
a checkpoint named by the caller, else (when neither that nor a quantized
random init is asked for) a snapshot of the preset in the local HF cache,
else random init from a seed. Given params (e.g. carried over from the JAX
package) come before all of them."""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, Optional

import torch

from llm_inference_lab_tpu_torch.models import transformer
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig


def create_family_model(configs: Dict[str, ModelConfig], name: str, *, device,
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        quantized_init: Optional[str] = None, quantize_embed: bool = False,
                        load_checkpoint: Callable, params: Optional[dict] = None,
                        checkpoint_path: Optional[str] = None) -> Model:
    """configs[name] on `device`: the given params; or the HF checkpoint at
    checkpoint_path (a snapshot directory or one .safetensors file), read
    by load_checkpoint(path, cfg, device), with the hyperparameters of its
    config.json where it has a readable one; or, when neither it nor
    quantized_init is given, the preset's snapshot in the local HF cache
    (models/loader.py find_cached_checkpoint); or a random init from a
    torch.Generator seeded with `seed` (directly in quantized form when
    quantized_init is "int4"/"int8"). Model.weights_source says which:
    "given", the checkpoint's path, or "random"."""
    from llm_inference_lab_tpu_torch.models import loader

    cfg = replace(configs[name], dtype=dtype)
    source = "given"
    if params is None:
        if checkpoint_path is None and not quantized_init:
            checkpoint_path = loader.find_cached_checkpoint(name)
        if checkpoint_path:
            try:
                cfg = loader.config_from_hf(loader.load_hf_config(checkpoint_path), name, dtype)
            except (FileNotFoundError, NotADirectoryError, KeyError, ValueError):
                pass  # no (or an odd) config.json: the preset's hyperparameters
            params = load_checkpoint(checkpoint_path, cfg, device)
            source = checkpoint_path
        else:
            g = torch.Generator(device=device).manual_seed(seed)
            if quantized_init:
                params = transformer.init_params_quantized(
                    cfg, g, device, mode=quantized_init, quantize_embed=quantize_embed)
            else:
                params = transformer.init_params(cfg, g, device)
            source = "random"
    return Model(config=cfg, params=params, weights_source=source)
