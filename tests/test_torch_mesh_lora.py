"""Port parity for LoRA, the fake model and the profiler under a mesh
(models/lora.py's pack sharded by parallel/sharding.py shard_params, the
row sites' deltas added to the rank's partial in models/transformer.py
_out_proj; Engine's fake model whole on every rank; profile_phases' eager
chains, metrics/profiler.py) against the JAX package on the CPU.

One launch of 4 gloo ranks (tests/torch_parallel_ranks.py, one thread
each) runs every check: llama-tiny (x10 weights) with JAX's two test
adapters (math: q, v; code: every site) at model 2 (a data 2 x model 2
mesh) and at seq 2 (data 2 x seq 2, the ring prefill adapting each rank's
rows), and mixtral-tiny with an adapter of its attention sites at expert 2
(data 2 x expert 2): generate_batch's ids under the base model and each
adapter equal JAX's unsharded LoRA engine's, and MultiHostBatcher's ids of
requests with base and adapted rows mixed equal JAX's ContinuousBatcher's
(under model 2 and expert 2; tests/test_torch_mesh_serving.py serves
under seq); the fake engine's ids at
data 2 x model 2 equal JAX's fake engine's; a profiled engine (llama-tiny
and its own weights as the draft, sharded with it) at model 2 and seq 2
returns JAX's phase keys with finite values and JAX's ids.
"""

import math

import numpy as np
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import lora as jl
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.models import lora
from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
from llm_inference_lab_tpu_torch.models.mixtral import MIXTRAL_CONFIGS
from llm_inference_lab_tpu_torch.parallel.multihost import launch

import torch_parallel_ranks as ranks
from test_torch_decode_loop import _jax_model, one_thread  # noqa: F401
from test_torch_expert import _mixtral
from test_torch_lora import adapters

PROMPTS = ["lora under a mesh, one", "and a second prompt"]
NAMES = [None, "math", "code"]
KW = dict(base_model="llama-tiny", draft_model=None, max_draft=2, max_new_tokens=12,
          max_seq_len=256, dtype="float32", eos_token_id=-1)
MOE_KW = dict(base_model="mixtral-tiny", draft_model=None, max_new_tokens=10, max_seq_len=128,
              dtype="float32", eos_token_id=-1)
REQS = [("shared adapters prompt", 12, None), ("shared adapters prompt", 12, "math"),
        ("shared adapters prompt", 10, "code"), ("another prompt for math", 8, "math"),
        ("a base request", 9, None)]
MOE_REQS = [("expert lora one", 8, "attn"), ("expert lora one", 8, None),
            ("a third expert request", 6, "attn")]
FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=3,
            max_new_tokens=12, max_seq_len=256)
PROFILE = dict(KW, draft_model="llama-tiny", shard_draft=True, profile=True)
SHAPES = [{"data": 2, "model": 2}, {"data": 2, "seq": 2}]
RUNS = {"model2": 0, "seq2": 1, "expert2": 2}


def moe_adapters(pkg, cfg):
    """An adapter of mixtral-tiny's attention sites (its experts take none)."""
    return [pkg.make_adapter(cfg, "attn", rank=4, alpha=512.0, targets=("q", "k", "v", "o"),
                             rng=np.random.default_rng(3))]


def _f32(cfg):
    import dataclasses

    import torch

    return dataclasses.replace(cfg, dtype=torch.float32)


@pytest.fixture(scope="module")
def fleet():
    """Every multi-rank check of this file in one launch of 4 ranks."""
    target = params_from_jax(_jax_model("llama-tiny", 1).params)
    ads = adapters(lora, _f32(LLAMA_CONFIGS["llama-tiny"]))
    moe = params_from_jax(_mixtral().params)
    items = [("lora_engine_ids", ({}, KW, target, ads, PROMPTS, SHAPES[0], NAMES, REQS)),
             ("lora_engine_ids", ({}, KW, target, ads, PROMPTS, SHAPES[1], NAMES)),
             ("lora_engine_ids", ({}, MOE_KW, moe,
                                  moe_adapters(lora, _f32(MIXTRAL_CONFIGS["mixtral-tiny"])),
                                  PROMPTS, {"data": 2, "expert": 2}, [None, "attn"],
                                  MOE_REQS)),
             ("fake_and_profile", ({}, FAKE, PROMPTS, PROFILE, target, target, SHAPES))]
    return launch(ranks.jobs, 4, args=(items,), threads=1, timeout=600)


def _jax_lora(moe: bool = False):
    if moe:
        target = _mixtral()
        return JaxEngine(JaxEngineConfig(implementation="hf", **MOE_KW), target_model=target,
                         lora_adapters=moe_adapters(jl, target.config))
    target = _jax_model("llama-tiny", 1)
    return JaxEngine(JaxEngineConfig(implementation="hf", **KW), target_model=target,
                     lora_adapters=adapters(jl, target.config))


def _jax_served(eng, reqs) -> list:
    b = JaxBatcher(eng, n_slots=4)
    rids = [b.submit(p, max_new_tokens=m, lora=name) for p, m, name in reqs]
    done = {r["req_id"]: r["generated_ids"] for r in b.run()}
    return [done[rid] for rid in rids]


@pytest.fixture(scope="module")
def jax_llama():
    eng = _jax_lora()
    batch = {name: [r["generated_ids"] for r in eng.generate_batch(PROMPTS, adapter=name)]
             for name in NAMES}
    return batch, _jax_served(eng, REQS)


@pytest.mark.parametrize("run", ["model2", "seq2"])
def test_lora_generate_batch_equals_jax(fleet, jax_llama, run):
    """generate_batch under the base model and each adapter at model 2 (the
    pack's column sites' B columns and row sites' A rows on each rank) and
    seq 2 (the pack whole, each rank adapting its rows of the ring
    prefill): JAX's unsharded LoRA engine's ids on every rank; the adapters
    change the ids."""
    want = jax_llama[0]
    assert want["math"] != want[None] and want["code"] != want[None]
    for r in range(4):
        assert fleet[r][RUNS[run]]["batch"] == want, ("rank", r)


def test_lora_batcher_under_model_equals_jax(fleet, jax_llama):
    """MultiHostBatcher at data 2 x model 2 with base, math and code
    requests mixed: JAX's ContinuousBatcher's ids, on every rank."""
    for r in range(4):
        assert fleet[r][RUNS["model2"]]["served"] == jax_llama[1], ("rank", r)


def test_lora_under_expert_equals_jax(fleet):
    """mixtral-tiny with an attention adapter at data 2 x expert 2 (the
    attention sites whole on every rank, the experts split):
    generate_batch's and the batcher's ids equal JAX's unsharded LoRA
    engine's and batcher's."""
    eng = _jax_lora(moe=True)
    want = {name: [r["generated_ids"] for r in eng.generate_batch(PROMPTS, adapter=name)]
            for name in (None, "attn")}
    assert want["attn"] != want[None]
    served = _jax_served(eng, MOE_REQS)
    for r in range(4):
        assert fleet[r][RUNS["expert2"]]["batch"] == want, ("rank", r)
        assert fleet[r][RUNS["expert2"]]["served"] == served, ("rank", r)


def test_fake_model_under_the_model_axis_equals_jax(fleet):
    """The fake engine at data 2 x model 2 runs whole on every rank (its
    decode loops not eager: no collective) with JAX's fake engine's ids."""
    want = [r["generated_ids"] for r in JaxEngine(JaxEngineConfig(**FAKE)).generate_batch(PROMPTS)]
    for r in range(4):
        assert fleet[r][-1]["fake"] == want and fleet[r][-1]["fake_eager"] is False, r


@pytest.mark.parametrize("shape", SHAPES, ids=["model2", "seq2"])
def test_profiler_under_a_mesh(fleet, jax_llama, shape):
    """A profiled generate_batch at model 2 and seq 2 (eager chains, the
    draft sharded with the target): JAX's phase keys (from JAX's profiled
    fake engine), finite values, no error, the parts summing to step_ms,
    the second profile_phases the cached one, steps recorded; the ids are
    JAX's base ids (the draft is the target: every draft accepted)."""
    jeng = JaxEngine(JaxEngineConfig(**dict(FAKE, profile=True)))
    jeng.generate("phase keys")
    jkeys = set(jeng.profiler.summary()["phase_ms"])
    key = "x".join(f"{k}{v}" for k, v in shape.items())
    for r in range(4):
        ids, summary, again, eager = fleet[r][-1][key]
        assert eager and ids == jax_llama[0][None], r
        ph = summary["phase_ms"]
        assert "error" not in ph and set(ph) == jkeys, ph
        assert all(math.isfinite(v) for v in ph.values()), ph
        assert ph["k"] == 2 and ph["draft_forwards"] == 2
        assert abs(ph["draft_ms"] + ph["verify_ms"] + ph["commit_sample_ms"]
                   - ph["step_ms"]) < 1e-3
        assert again == ph and summary["step_ms"]["n"] > 0
