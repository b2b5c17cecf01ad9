"""Qwen2 / Qwen2.5 family presets (port of llm_inference_lab_tpu/models/
qwen2.py).

A Llama-architecture variant with a bias on the fused q/k/v projection
only (ModelConfig.qkv_bias). The 0.5B draft and the 7B target share the
151,936-token vocabulary: the JAX package's configs/qwen25_pair.yaml.
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import loader
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

_COMMON = dict(arch="llama", vocab_size=151936, rope_theta=1000000.0, rms_norm_eps=1e-6,
               qkv_bias=True, max_position_embeddings=32768)

QWEN2_CONFIGS = {
    "qwen2.5-0.5b": ModelConfig(
        name="qwen2.5-0.5b", n_layers=24, n_heads=14, n_kv_heads=2, d_model=896, d_ff=4864,
        tie_word_embeddings=True, **_COMMON,
    ),
    "qwen2.5-1.5b": ModelConfig(
        name="qwen2.5-1.5b", n_layers=28, n_heads=12, n_kv_heads=2, d_model=1536, d_ff=8960,
        tie_word_embeddings=True, **_COMMON,
    ),
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b", n_layers=28, n_heads=28, n_kv_heads=4, d_model=3584, d_ff=18944,
        tie_word_embeddings=False, **_COMMON,
    ),
}


def create(name: str, **kw) -> Model:
    """A Qwen2 model: the keywords of factory.create_family_model."""
    return create_family_model(QWEN2_CONFIGS, name, load_checkpoint=loader.load_llama_checkpoint, **kw)
