"""Llama family presets (port of llm_inference_lab_tpu/models/llama.py)."""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import loader
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

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
    # JAX's eagle_8b_int4 target (scripts/headline_suite.py): an untied head.
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b", vocab_size=128256, n_layers=32, n_heads=32, n_kv_heads=8,
        d_model=4096, d_ff=14336, max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192), tie_word_embeddings=False,
    ),
    # Tiny config for tests (CPU-fast, same code path as the real sizes)
    "llama-tiny": ModelConfig(
        name="llama-tiny", vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_model=64, d_ff=128, max_position_embeddings=512, tie_word_embeddings=True,
    ),
}


def create(name: str, **kw) -> Model:
    """A Llama model: the keywords of factory.create_family_model."""
    return create_family_model(LLAMA_CONFIGS, name, load_checkpoint=loader.load_llama_checkpoint, **kw)
