"""GPT-2 family presets (port of llm_inference_lab_tpu/models/gpt2.py):
learned positions, LayerNorm with biases, a plain tanh-gelu MLP with
biases, a fused QKV with its bias, the tied head. The JAX package's
configs/baseline.yaml runs ``gpt2`` without a draft.
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import loader
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

_COMMON = dict(arch="gpt2", vocab_size=50257, max_position_embeddings=1024,
               use_learned_pos=True, use_bias=True, act="gelu", tie_word_embeddings=True)

GPT2_CONFIGS = {
    "gpt2": ModelConfig(name="gpt2", n_layers=12, n_heads=12, n_kv_heads=12, d_model=768,
                        d_ff=3072, **_COMMON),
    "distilgpt2": ModelConfig(name="distilgpt2", n_layers=6, n_heads=12, n_kv_heads=12,
                              d_model=768, d_ff=3072, **_COMMON),
    "gpt2-medium": ModelConfig(name="gpt2-medium", n_layers=24, n_heads=16, n_kv_heads=16,
                               d_model=1024, d_ff=4096, **_COMMON),
}


def create(name: str, **kw) -> Model:
    """A GPT-2 model: the keywords of factory.create_family_model."""
    return create_family_model(GPT2_CONFIGS, name, load_checkpoint=loader.load_gpt2_checkpoint, **kw)
