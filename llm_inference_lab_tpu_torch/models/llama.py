"""Llama family presets and a factory that random-inits (port of
llm_inference_lab_tpu/models/llama.py and models/factory.py). Loading a
checkpoint comes with a later slice."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from llm_inference_lab_tpu_torch.models import transformer
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig

LLAMA_CONFIGS = {
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b", vocab_size=128256, n_layers=16, n_heads=32, n_kv_heads=8,
        d_model=2048, d_ff=8192, max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192), tie_word_embeddings=True,
    ),
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b", vocab_size=128256, n_layers=28, n_heads=24, n_kv_heads=8,
        d_model=3072, d_ff=8192, max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192), tie_word_embeddings=True,
    ),
    # Tiny config for tests (CPU-fast, same code path as the real sizes)
    "llama-tiny": ModelConfig(
        name="llama-tiny", vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_model=64, d_ff=128, max_position_embeddings=512, tie_word_embeddings=True,
    ),
}


def create(name: str, *, device, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
           quantized_init: Optional[str] = None, quantize_embed: bool = False,
           params: Optional[dict] = None) -> Model:
    """A Llama model on `device`: the given params, or a random init from a
    torch.Generator seeded with `seed` (directly in quantized form when
    quantized_init is "int4"/"int8")."""
    cfg = replace(LLAMA_CONFIGS[name], dtype=dtype)
    if params is None:
        g = torch.Generator(device=device).manual_seed(seed)
        if quantized_init:
            params = transformer.init_params_quantized(
                cfg, g, device, mode=quantized_init, quantize_embed=quantize_embed)
        else:
            params = transformer.init_params(cfg, g, device)
    return Model(config=cfg, params=params)
