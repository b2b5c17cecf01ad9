"""Phi-3 family presets (port of llm_inference_lab_tpu/models/phi3.py).

A Llama-architecture variant (untied head) whose HF checkpoints hold the
q/k/v and gate/up projections already fused (models/loader.py
load_phi3_checkpoint). Head dim 3072 / 32 = 96, and mini-4k's window of 2047
binds below its 4096 positions.
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import loader
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

PHI3_CONFIGS = {
    "phi-3-mini-4k-instruct": ModelConfig(
        name="phi-3-mini-4k-instruct", arch="llama", vocab_size=32064, n_layers=32, n_heads=32,
        n_kv_heads=32, d_model=3072, d_ff=8192, max_position_embeddings=4096,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False, sliding_window=2047,
    ),
    # Tiny preset for tests (the same conventions, toy dims).
    "phi3-tiny": ModelConfig(
        name="phi3-tiny", arch="llama", vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=4,
        d_model=32, d_ff=64, max_position_embeddings=512, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, sliding_window=None,
    ),
}


def create(name: str, **kw) -> Model:
    """A Phi-3 model: the keywords of factory.create_family_model."""
    return create_family_model(PHI3_CONFIGS, name, load_checkpoint=loader.load_phi3_checkpoint, **kw)
