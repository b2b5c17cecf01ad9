"""Mistral family presets (port of llm_inference_lab_tpu/models/mistral.py).

A Llama-architecture variant with a sliding window on every layer
(ModelConfig.sliding_window; Mistral-7B-v0.1's window is 4096) and an
untied head. A uniform window is what the rolling-buffer cache
(EngineConfig.kv_ring) needs: the engine rings these models' caches.
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

MISTRAL_CONFIGS = {
    "mistral-7b": ModelConfig(
        name="mistral-7b", arch="llama", vocab_size=32000, n_layers=32, n_heads=32,
        n_kv_heads=8, d_model=4096, d_ff=14336, max_position_embeddings=32768,
        rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4096, tie_word_embeddings=False,
    ),
    # Tiny config for tests: a window of 16 binds in short prompts, so the
    # window mask and the ring cache run on the CPU in milliseconds.
    "mistral-tiny": ModelConfig(
        name="mistral-tiny", arch="llama", vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_model=64, d_ff=128, max_position_embeddings=1024, sliding_window=16,
        tie_word_embeddings=True,
    ),
}


def create(name: str, **kw) -> Model:
    """A Mistral model: the keywords of factory.create_family_model."""
    return create_family_model(MISTRAL_CONFIGS, name, **kw)
