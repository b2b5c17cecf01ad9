"""OPT family presets (port of llm_inference_lab_tpu/models/opt.py):
GPT-2's structure with a relu MLP and learned positions read at position +
2 (HF OPT's offset). opt-350m is not a preset (its word_embed_proj_dim
differs from the hidden size; loader.config_from_hf refuses it). The JAX
package's configs/opt_baseline.yaml runs ``opt-125m`` without a draft.
"""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import loader
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.factory import create_family_model

_COMMON = dict(arch="opt", vocab_size=50272, max_position_embeddings=2048,
               use_learned_pos=True, use_bias=True, act="relu", pos_offset=2,
               tie_word_embeddings=True)

OPT_CONFIGS = {
    "opt-125m": ModelConfig(name="opt-125m", n_layers=12, n_heads=12, n_kv_heads=12,
                            d_model=768, d_ff=3072, **_COMMON),
    "opt-1.3b": ModelConfig(name="opt-1.3b", n_layers=24, n_heads=32, n_kv_heads=32,
                            d_model=2048, d_ff=8192, **_COMMON),
}


def create(name: str, **kw) -> Model:
    """An OPT model: the keywords of factory.create_family_model."""
    return create_family_model(OPT_CONFIGS, name, load_checkpoint=loader.load_opt_checkpoint, **kw)
