"""Port parity for the multi-process batcher (core/multihost_batching.py)
and the shared build (build.py) against the JAX package on the CPU.

JAX's worker workload (scripts/multihost_worker.py: tiny(1, 2) target and
tiny(2, 1) draft, 4 slots, max_draft 3, f32, its 6 prompts and budgets)
runs on 4 gloo ranks, data 2 x model 2 (make_multihost_mesh with
model_per_host=2), through the port's MultiHostBatcher; the coordinator's
results equal JAX's ContinuousBatcher in one process on the same weights
(JAX's single-process MultiHostBatcher is that class exactly), and every
rank's ids equal the coordinator's, for the contiguous and the paged
layout, lazy pages with a 10-page pool (at least one grow and one
preemption asserted) and the device-side adaptive K. The four modes run in
one launch of the ranks (tests/torch_parallel_ranks.py, one thread each).
In one process MultiHostBatcher gives ContinuousBatcher's results. The
build test runs build.build_all with a fake compiler from two ranks at once.
"""

import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import Model as JaxModel
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.multihost_batching import MultiHostBatcher
from llm_inference_lab_tpu_torch.models import llama
from llm_inference_lab_tpu_torch.models.base import ModelConfig
from llm_inference_lab_tpu_torch.parallel.multihost import (
    broadcast_from_rank0,
    initialize_multihost,
    launch,
    make_multihost_mesh,
)
from functools import partial

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401

KEYS = ("req_id", "generated_ids", "generated_tokens", "text")


def tiny_kw(seed: int, layers: int) -> dict:
    """The worker's tiny(seed, layers) config (scripts/multihost_worker.py)."""
    return dict(name=f"mh-{seed}", arch="llama", vocab_size=256, n_layers=layers, n_heads=4,
                n_kv_heads=2, d_model=32, d_ff=64, max_position_embeddings=512)


def jax_tiny(seed: int, layers: int) -> JaxModel:
    cfg = JaxModelConfig(dtype=jnp.float32, **tiny_kw(seed, layers))
    return JaxModel(config=cfg, params=jt.init_params(cfg, jax.random.PRNGKey(seed)),
                    apply_fn=partial(jt.forward, cfg), head_fn=partial(jt.lm_head_logits, cfg))


@pytest.fixture(scope="module")
def weights():
    target, draft = jax_tiny(1, 2), jax_tiny(2, 1)
    configs = {"mh-1": ModelConfig(dtype=torch.float32, **tiny_kw(1, 2)),
               "mh-2": ModelConfig(dtype=torch.float32, **tiny_kw(2, 1))}
    return target, draft, configs, params_from_jax(target.params), params_from_jax(draft.params)


@pytest.fixture(scope="module")
def fleet(weights):
    """Every mode through MultiHostBatcher on 4 ranks: each rank's
    {mode: (results, stats)}."""
    _, _, configs, tparams, dparams = weights
    return launch(ranks.multihost_serve, 4, args=(configs, tparams, dparams,
                                                  list(ranks.MH_MODES)),
                  threads=1, timeout=600)


_JAX_RESULTS: dict = {}


def jax_single(weights, mode: str) -> list:
    """JAX's ContinuousBatcher in one process (the worker's --nprocs 1),
    once a mode."""
    if mode not in _JAX_RESULTS:
        _JAX_RESULTS[mode] = _jax_run(weights, mode)
    return _JAX_RESULTS[mode]


def _jax_run(weights, mode: str) -> list:
    target, draft = weights[:2]
    kw = ranks.mh_config(mode)
    for port_only in ("base_model", "draft_model"):
        kw.pop(port_only)
    eng = JaxEngine(JaxEngineConfig(implementation="hf", **kw), target_model=target,
                    draft_model=draft)
    b = JaxBatcher(eng, n_slots=4)
    for prompt, budget in zip(ranks.MH_PROMPTS, ranks.mh_budgets(mode, kw["max_new_tokens"])):
        b.submit(prompt, max_new_tokens=budget)
    return [{k: r[k] for k in KEYS} for r in b.run()]


@pytest.mark.parametrize("mode", list(ranks.MH_MODES))
def test_four_ranks_equal_jax_single_process(weights, fleet, mode):
    results, stats = fleet[0][mode]
    assert len(results) == len(ranks.MH_PROMPTS)
    assert results == jax_single(weights, mode)
    for r in range(1, 4):
        assert [x["generated_ids"] for x in fleet[r][mode][0]] == [
            x["generated_ids"] for x in results], ("rank", r)
    if mode == "lazy":  # the tiny pool must have forced growth and preemption
        assert stats["page_grows"] > 0 and stats["preemptions"] > 0, stats


def test_broadcast_from_rank0_on_four_ranks(fleet):
    for r in range(4):
        ints, floats = fleet[r]["broadcast"]
        assert ints.tolist() == [0, 0, 0] and floats.tolist() == [0.0, 1.0]


def test_continuous_batcher_on_the_model_axis_equals_jax(weights):
    """ContinuousBatcher on model=2 alone, 2 ranks submitting the same
    requests (its host decisions alike on both: no wall-clock refit under a
    mesh), paged: both ranks' results equal JAX's single process."""
    _, _, configs, tparams, dparams = weights
    got = launch(ranks.tp_batcher, 2, args=(configs, tparams, dparams, "paged"), threads=1,
                 timeout=300)
    want = jax_single(weights, "paged")
    assert got[0] == want and got[1] == want


def test_one_process_is_continuous_batcher(weights, one_thread):  # noqa: F811
    """No mesh: MultiHostBatcher is ContinuousBatcher (its switches, one-shot
    admission, are JAX's)."""
    _, _, configs, tparams, dparams = weights
    saved = dict(llama.LLAMA_CONFIGS)
    llama.LLAMA_CONFIGS.update(configs)
    try:
        kw = ranks.mh_config("paged")
        out = []
        for cls in (MultiHostBatcher, ContinuousBatcher):
            b = cls(Engine(EngineConfig(**kw), device="cpu", target_params=tparams,
                           draft_params=dparams), n_slots=4)
            assert b.n_slots == 4
            for prompt, budget in zip(ranks.MH_PROMPTS, ranks.mh_budgets("paged", 16)):
                b.submit(prompt, max_new_tokens=budget)
            out.append([{k: r[k] for k in KEYS} for r in b.run()])
        assert out[0] == out[1]
    finally:
        llama.LLAMA_CONFIGS.clear()
        llama.LLAMA_CONFIGS.update(saved)


def test_helpers_in_one_process():
    """JAX's test_multihost_helpers_single_process: a no-op init, a mesh of
    one rank, broadcast returning its input."""
    info = initialize_multihost()
    assert info["process_count"] == 1 and info["process_index"] == 0
    mesh = make_multihost_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    x = torch.arange(3).numpy()
    assert broadcast_from_rank0(x) is x


@pytest.mark.parametrize("kind,says,timeout", [("raise", "this rank was told to fail", 120),
                                               ("hang", "not done within", 8),
                                               ("die", "exited with code 3", 120)])
def test_launch_raises_for_a_rank_that_fails(kind, says, timeout):
    """A rank that raises, hangs or dies makes launch raise with what it
    left; the others are stopped."""
    with pytest.raises(RuntimeError, match=says):
        launch(ranks.misbehave, 2, args=(kind, 1), timeout=timeout)


FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = open(sys.argv[-1], "rb").read()
with open(os.path.join({root!r}, "calls"), "a") as f:
    f.write(os.path.basename(sys.argv[-1]) + "\\n")
with open(out, "wb") as f:
    f.write(b"lib:" + src[:4])
    f.flush()
    time.sleep(0.5)
    f.write(src[4:])
"""


def test_build_from_two_ranks_at_once(tmp_path):
    """Two ranks reach two unbuilt libraries together: each library is
    compiled once, both ranks see it whole, no temporary file is left."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "csrc"))
    for name in ("alpha", "beta"):
        with open(os.path.join(root, "csrc", f"{name}.cu"), "w") as f:
            f.write(f"// {name} source " * 20)
    nvcc = os.path.join(root, "fake_nvcc")
    with open(nvcc, "w") as f:
        f.write(FAKE_NVCC.format(python=sys.executable, root=root))
    os.chmod(nvcc, 0o755)
    got = launch(ranks.fake_build, 2, args=(root, 0.0), timeout=120)
    assert got[0] == got[1] and len(got[0]) == 2
    for name, data in got[0]:
        src = name.split("-")[0][3:]
        assert data == b"lib:" + open(os.path.join(root, "csrc", f"{src}.cu"), "rb").read()
    with open(os.path.join(root, "calls")) as f:
        assert sorted(f.read().split()) == ["alpha.cu", "beta.cu"]
    assert not [p for p in os.listdir(os.path.join(root, "_build")) if ".tmp" in p]
