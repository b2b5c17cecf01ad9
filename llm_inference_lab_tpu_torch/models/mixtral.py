"""Mixtral family presets (port of llm_inference_lab_tpu/models/mixtral.py).

Mistral's attention (GQA) with a top-2-routed 8-expert gated-MLP block a
layer (ops/moe.py; HF modeling_mixtral's softmax over the top-k router
logits). As in JAX, the experts have no quantized random init:
``quantized_init`` raises.
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import loader
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

MIXTRAL_CONFIGS = {
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", arch="llama", vocab_size=32000, n_layers=32, n_heads=32,
        n_kv_heads=8, d_model=4096, d_ff=14336, max_position_embeddings=32768, rope_theta=1e6,
        rms_norm_eps=1e-5, tie_word_embeddings=False, n_experts=8, experts_per_token=2,
    ),
    # Test-scale geometry: the same structure, tiny dims.
    "mixtral-tiny": ModelConfig(
        name="mixtral-tiny", arch="llama", vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_model=64, d_ff=128, max_position_embeddings=512, tie_word_embeddings=True,
        n_experts=4, experts_per_token=2,
    ),
}


def create(name: str, **kw) -> Model:
    """A Mixtral model: the keywords of factory.create_family_model."""
    if kw.get("quantized_init"):
        raise NotImplementedError("quantized random init for MoE expert stacks is not "
                                  "implemented; use bf16 init or a real checkpoint")
    return create_family_model(MIXTRAL_CONFIGS, name, load_checkpoint=loader.load_mixtral_checkpoint, **kw)
