"""Medusa head training (core/head_training.py) against the JAX package on
the CPU.

collect_hidden_targets gives JAX's hidden states and targets for the same
sequences; train_medusa_heads (torch.optim.Adam) follows optax.adam's loss
history from the same init; self-distillation raises medusa's acceptance
and leaves the ids the target's greedy ones, as JAX's test asserts; a head
through kernel A (a quantized untied head) raises.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.core.head_training import (
    collect_hidden_targets as jax_collect,
)
from llm_inference_lab_tpu.core.head_training import train_medusa_heads as jax_train
from llm_inference_lab_tpu.models.llama import LlamaModel
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.head_training import (
    collect_hidden_targets,
    self_distill_medusa,
    train_medusa_heads,
)
from llm_inference_lab_tpu_torch.models.factory import create_family_model
from llm_inference_lab_tpu_torch.models.loader import load_llama_checkpoint
from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
from llm_inference_lab_tpu_torch.models.registry import create
from test_torch_decode_loop import one_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _jax_tiny(seed=0):
    return LlamaModel.create("llama-tiny", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)


def _tiny(seed=0):
    return create("llama-tiny", device="cpu", dtype=torch.float32,
                  params=params_from_jax(_jax_tiny(seed).params))


def _seqs(seed, shape):
    return np.random.default_rng(seed).integers(1, 255, shape).astype(np.int32)


def test_collect_hidden_targets_equals_jax():
    """Shapes, the lookahead alignment (tgt[:, t, d] == seqs[:, t + 2 + d])
    and the targets exactly; the hidden states within 1e-5 of the largest
    (two f32 forwards)."""
    seqs = _seqs(0, (2, 20))
    hid, tgt = collect_hidden_targets(_tiny(), torch.from_numpy(seqs), num_heads=2)
    jhid, jtgt = jax_collect(_jax_tiny(), jnp.asarray(seqs), num_heads=2)
    assert hid.shape == (2, 17, 64) and tgt.shape == (2, 17, 2)
    assert int(tgt[0, 3, 1]) == int(seqs[0, 6])
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    jhid = np.asarray(jhid)
    np.testing.assert_allclose(hid.numpy(), jhid, rtol=0, atol=1e-5 * np.abs(jhid).max())


def test_training_follows_optax():
    """20 Adam steps at lr 5e-3 from identity heads on the same sequences:
    every recorded loss within 1e-5 relative of optax's (f32 forwards and
    updates in another order; measured 2e-6), and the loss falls."""
    seqs = _seqs(1, (4, 24))
    proj, hist = train_medusa_heads(_tiny(), seqs, num_heads=2, steps=20, lr=5e-3)
    jproj, jhist = jax_train(_jax_tiny(), seqs, num_heads=2, steps=20, lr=5e-3)
    assert proj.shape == (2, 64, 64) and len(hist) == len(jhist) == 11
    np.testing.assert_allclose(hist, jhist, rtol=1e-5, atol=0)
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=0, atol=1e-4)
    assert hist[-1] < hist[0]


def test_self_distillation_improves_acceptance():
    """JAX's test: trained heads accept at least as often as identity heads
    on a held-out prompt, above 0.3, and the ids stay the target's greedy
    ones; the engine's heads are updated in place."""
    cfg = dict(base_model="llama-tiny", draft_model=None, max_new_tokens=32, dtype="float32",
               max_seq_len=256)
    params = params_from_jax(_jax_tiny().params)
    eng = Engine(EngineConfig(draft_mode="medusa", max_draft=2, **cfg), device="cpu",
                 target_params=params)
    heads = eng._draft_params["medusa_proj"]
    before = eng.generate("held out prompt")["acceptance_rate"]
    proj, hist = self_distill_medusa(eng, ["seed prompt one", "another seed",
                                           "third training prompt"],
                                     steps=120, lr=5e-3, tokens_per_prompt=48)
    assert proj.shape[0] == 2 and hist[-1] < hist[0]
    assert eng._draft_params["medusa_proj"] is heads and torch.equal(heads, proj)
    after = eng.generate("held out prompt")
    assert after["acceptance_rate"] >= before and after["acceptance_rate"] > 0.3
    base = Engine(EngineConfig(**cfg), device="cpu", target_params=params)
    assert after["generated_ids"] == base.generate("held out prompt")["generated_ids"]


def test_quantized_untied_head_raises():
    """Kernel A has no backward: a head through it refuses to train, on any
    device; the int8 tied head trains."""
    untied = {"untied": replace(LLAMA_CONFIGS["llama-tiny"], tie_word_embeddings=False)}
    quantized = create_family_model(untied, "untied", device="cpu", dtype=torch.float32,
                                    quantized_init="int4", load_checkpoint=load_llama_checkpoint)
    with pytest.raises(NotImplementedError, match="kernel A"):
        train_medusa_heads(quantized, _seqs(2, (2, 12)), num_heads=1, steps=1)
    tied = create("llama-tiny", device="cpu", dtype=torch.float32, quantized_init="int8",
                  quantize_embed=True)
    _, hist = train_medusa_heads(tied, _seqs(2, (2, 12)), num_heads=1, steps=3)
    assert all(np.isfinite(hist))
