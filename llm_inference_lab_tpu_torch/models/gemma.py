"""Gemma family presets (port of llm_inference_lab_tpu/models/gemma.py).

A Llama-architecture variant: head_dim decoupled from d_model / n_heads
(256 regardless), a sqrt(d_model) input-embedding scale cast to the compute
dtype, RMSNorm weights stored as (w - 1), GeGLU (a tanh-approximated gelu
gate) and tied embeddings. Gemma-2 adds attention and final logit softcaps,
the score scale query_pre_attn_scalar**-0.5, sandwich norms after both
blocks and a sliding window on every other layer (even layers local, odd
layers global).
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

_COMMON = dict(
    arch="llama",
    vocab_size=256000,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    head_dim_override=256,
    embed_scale=True,
    rms_one_offset=True,
    act="gelu_tanh",
)

GEMMA_CONFIGS = {
    "gemma-2b": ModelConfig(
        name="gemma-2b", n_layers=18, n_heads=8, n_kv_heads=1,
        d_model=2048, d_ff=16384, **_COMMON,
    ),
    "gemma-7b": ModelConfig(
        name="gemma-7b", n_layers=28, n_heads=16, n_kv_heads=16,
        d_model=3072, d_ff=24576, **_COMMON,
    ),
    # Tiny config for tests: every Gemma wrinkle at toy size.
    "gemma-tiny": ModelConfig(
        name="gemma-tiny", n_layers=2, n_heads=4, n_kv_heads=1,
        d_model=64, d_ff=128, **{**_COMMON, "vocab_size": 256, "head_dim_override": 32},
    ),
}

_COMMON2 = dict(
    **_COMMON,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    alt_window=True,
    sliding_window=4096,
)

GEMMA_CONFIGS.update({
    "gemma-2-2b": ModelConfig(
        name="gemma-2-2b", n_layers=26, n_heads=8, n_kv_heads=4,
        d_model=2304, d_ff=9216, query_pre_attn_scalar=256.0, **_COMMON2,
    ),
    "gemma-2-9b": ModelConfig(
        name="gemma-2-9b", n_layers=42, n_heads=16, n_kv_heads=8,
        d_model=3584, d_ff=14336, query_pre_attn_scalar=256.0, **_COMMON2,
    ),
    # Tiny config for tests: a window of 16 binds in short prompts, and
    # query_pre_attn_scalar 24 differs from head_dim 32.
    "gemma2-tiny": ModelConfig(
        name="gemma2-tiny", n_layers=4, n_heads=4, n_kv_heads=2,
        d_model=64, d_ff=128, query_pre_attn_scalar=24.0,
        **{**_COMMON2, "vocab_size": 256, "head_dim_override": 32, "sliding_window": 16},
    ),
})


def create(name: str, **kw) -> Model:
    """A Gemma model: the keywords of factory.create_family_model."""
    return create_family_model(GEMMA_CONFIGS, name, **kw)
