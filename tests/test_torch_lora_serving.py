"""Port parity: multi-LoRA serving (core/batching.py submit(lora=...), every
admission route writing the slot's adapter, models/paged.py's prefix cache
keyed by adapter, the server's ``model`` routing and /v1/models) against
the JAX package on the CPU.

The batcher cases run JAX's batcher and the port's through the same
explicit admit / step_chunk / retire calls (test_torch_lazy_pages.py
``drive``): the slots' page ids, reuse lengths and stats after every poll,
each request's ids and finish reason exact, logprobs within 1e-4; and each
request's ids equal its B=1 ``generate(adapter=...)``. Weights:
test_torch_decode_loop.py's llama-tiny with tests/test_lora.py's adapters
(test_torch_lora.py ``adapters``).

The reference's fault: JAX's prefix cache hashes tokens only, so a request
under one adapter reuses pages another adapter (or the base) wrote, and
decodes over their K and V rows
(``test_jax_prefix_cache_shares_pages_across_adapters``). The port's
chains start at the adapter, so pages are shared only within one, and its
results equal the cache-off run (``test_port_prefix_cache_keys_by_adapter``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.features import expected_error
from llm_inference_lab_tpu.models import lora as jl
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import lora
from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
from llm_inference_lab_tpu_torch.server import InferenceServer
from test_torch_decode_loop import SYNC, _jax_model, one_thread  # noqa: F401
from test_torch_lazy_pages import drive, same_results
from test_torch_lora import adapters
from test_torch_server import _error, _get, _post

CFG = dict(base_model="llama-tiny", draft_model=None, max_draft=2, max_new_tokens=12,
           max_seq_len=256, dtype="float32", eos_token_id=-1)
PAGED = dict(kv_layout="paged", kv_page_size=16)
REQS = [("shared adapters prompt", 12, None), ("shared adapters prompt", 12, "math"),
        ("shared adapters prompt", 10, "code"), ("another prompt for math", 8, "math"),
        ("a base request", 9, None)]


def _jax_engine(cfg):
    target = _jax_model("llama-tiny", 1)
    return JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     lora_adapters=adapters(jl, target.config))


def _port_engine(cfg, flags=None):
    target = _jax_model("llama-tiny", 1)
    tcfg = dataclasses.replace(LLAMA_CONFIGS["llama-tiny"], dtype=torch.float32)
    return Engine(EngineConfig(**cfg), device="cpu", flags=flags,
                  target_params=params_from_jax(target.params),
                  lora_adapters=adapters(lora, tcfg))


def _drive(b, reqs):
    """drive() with per-request adapters: submit (prompt, budget, lora), then
    the same explicit admit / step / retire calls."""
    rids = [b.submit(p, max_new_tokens=m, lora=name) for p, m, name in reqs]
    _, trace = drive(b, [])
    return {rid: b._done[rid].result for rid in rids}, trace


def _b1(cfg, reqs):
    """Each request alone through the port's generate(adapter=...)."""
    eng = _port_engine(dict(cfg, kv_layout="contiguous", prefix_caching=False, kv_pages=None))
    out = []
    for prompt, budget, name in reqs:
        eng.config.max_new_tokens = budget
        out.append(eng.generate(prompt, adapter=name)["generated_ids"])
    return out


LAYOUTS = {"contiguous": {}, "paged": PAGED}


@pytest.mark.parametrize("flags", ["loop", "host step"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batcher_adapters_equal_jax(layout, flags):
    """Five requests (base, math, code, math, base) through 3 slots: JAX's
    batcher's per-poll slots and pages, stats, ids and logprobs; each
    request's ids its B=1 generate under its adapter; the adapters bite
    (math's and code's ids differ from the base's on the same prompt)."""
    cfg = dict(CFG, **LAYOUTS[layout])
    jb = JaxBatcher(_jax_engine(cfg), n_slots=3)
    want, jtrace = _drive(jb, REQS)
    b = ContinuousBatcher(_port_engine(cfg, SYNC if flags == "host step" else None), n_slots=3)
    got, trace = _drive(b, REQS)
    same_results(got, want, trace, jtrace, jb, b)
    ref = _b1(cfg, REQS)
    for rid, ids in enumerate(ref):
        assert got[rid]["generated_ids"] == ids, rid
    assert ref[0] != ref[1] and ref[0] != ref[2]


def test_unknown_adapter_refused():
    """An adapter the engine does not have: the port refuses it at submit
    with JAX's message (JAX's batcher raises it at admission), and the
    engine with no pack refuses any."""
    jb = JaxBatcher(_jax_engine(CFG), n_slots=2)
    jb.submit("x", lora="nope")
    with pytest.raises(ValueError, match="unknown LoRA adapter 'nope'") as jerr:
        jb.run()
    b = ContinuousBatcher(_port_engine(CFG), n_slots=2)
    with pytest.raises(ValueError, match="unknown LoRA adapter 'nope'") as err:
        b.submit("x", lora="nope")
    assert str(err.value) == str(jerr.value)
    plain = Engine(EngineConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match=r"unknown LoRA adapter 'math' \(engine has \[\]\)"):
        ContinuousBatcher(plain, n_slots=1).submit("x", lora="math")


def test_resume_after_preemption_keeps_the_adapter():
    """A pool too small for both requests' growth: the younger (under math)
    is preempted and resumed by recompute under its adapter, to JAX's ids
    and pages, and to its uninterrupted generate(adapter="math")."""
    cfg = dict(CFG, **PAGED, kv_pages=8, max_new_tokens=48)
    reqs = [("preempt victim check", 48, None), ("preempt survivor check", 48, "math")]
    jb = JaxBatcher(_jax_engine(cfg), n_slots=2)
    want, jtrace = _drive(jb, reqs)
    b = ContinuousBatcher(_port_engine(cfg), n_slots=2)
    got, trace = _drive(b, reqs)
    same_results(got, want, trace, jtrace, jb, b)
    assert b.stats.preemptions >= 1
    resumed = [r for r in b._done.values() if r.resume_ids is not None]
    assert resumed and all(r.lora_id >= 0 for r in resumed)
    for rid, ids in enumerate(_b1(cfg, reqs)):
        assert got[rid]["generated_ids"] == ids, rid


SYSTEM = "common system prefix " * 8
PREFIX_CFG = dict(CFG, **PAGED, max_seq_len=512, kv_pages=40, prefix_caching=True)
# The base writes the system prompt's pages first; then the same prompt's
# tail under math, twice (the second may share the first's pages).
PREFIX_REQS = [(SYSTEM + "tail A", 12, None), (SYSTEM + "tail B", 12, "math"),
               (SYSTEM + "tail C", 12, "math")]


def _one_at_a_time(b, reqs):
    """Each request admitted after the one before retired, so its admission
    sees the pages the earlier ones registered."""
    out = []
    for prompt, budget, name in reqs:
        rid = b.submit(prompt, max_new_tokens=budget, lora=name)
        drive(b, [])
        out.append(b._done[rid].result)
    return out


def test_jax_prefix_cache_shares_pages_across_adapters():
    """The reference's fault: JAX's math request reuses the pages the base
    request wrote (its K and V rows are the base model's), so its logprobs
    part from its own cache-off run by far more than the forwards'
    rounding."""
    cached = _one_at_a_time(JaxBatcher(_jax_engine(PREFIX_CFG), n_slots=1), PREFIX_REQS)
    off = _one_at_a_time(JaxBatcher(_jax_engine(dict(PREFIX_CFG, prefix_caching=False)),
                                    n_slots=1), PREFIX_REQS)
    assert cached[1]["prompt_tokens_reused"] > 0
    gap = np.abs(np.array(cached[1]["token_logprobs"]) - np.array(off[1]["token_logprobs"]))
    assert gap.max() > 1e-2 or cached[1]["generated_ids"] != off[1]["generated_ids"]


def test_port_prefix_cache_keys_by_adapter():
    """The port's math request reuses none of the base's pages; the second
    math request reuses the first's; every request's ids equal its cache-off
    run's and logprobs within 1e-4."""
    b = ContinuousBatcher(_port_engine(PREFIX_CFG), n_slots=1)
    cached = _one_at_a_time(b, PREFIX_REQS)
    off = _one_at_a_time(ContinuousBatcher(_port_engine(dict(PREFIX_CFG, prefix_caching=False)),
                                           n_slots=1), PREFIX_REQS)
    assert [r["prompt_tokens_reused"] for r in cached] == [0, 0, 160]
    for got, want in zip(cached, off):
        assert got["generated_ids"] == want["generated_ids"]
        np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=1e-4)
    # The base's and math's chains of the same system prompt: different hashes.
    tokens = b.engine.encode(SYSTEM, 12, 512)
    assert not set(b.allocator.chunk_hashes(tokens)) & set(
        b.allocator.chunk_hashes(tokens, ("lora", 0)))


@pytest.fixture(scope="module")
def lora_server():
    srv = InferenceServer(_port_engine(dict(CFG, max_new_tokens=8)), n_slots=2, port=0)
    srv.start()
    yield srv
    srv.stop()


def test_server_models_and_routing(lora_server):
    """/v1/models lists the base and each adapter (with its parent, JAX's
    listing); `model` routes to an adapter, whose text is its B=1
    generate's; the base's name and no name give the base; any other name
    is a 404 with JAX's text."""
    models = json.loads(_get(lora_server, "/v1/models"))["data"]
    assert models == [{"id": "llama-tiny", "object": "model"},
                      {"id": "code", "object": "model", "parent": "llama-tiny"},
                      {"id": "math", "object": "model", "parent": "llama-tiny"}]
    eng = lora_server.engine

    def text(**kw):
        return _post(lora_server, "/v1/completions",
                     dict(prompt="route", max_tokens=8, **kw))["choices"][0]["text"]

    base, again, math = text(), text(model="llama-tiny"), text(model="math")
    assert base == again != math
    eng_b1 = _port_engine(dict(CFG, max_new_tokens=8))
    assert math == eng_b1.generate("route", adapter="math")["text"]
    assert base == eng_b1.generate("route")["text"]
    assert eng is lora_server.batcher.engine
    code, msg = _error(lora_server, "/v1/completions", {"prompt": "x", "model": "ghost"})
    assert (code, msg) == (404, "model 'ghost' not found (base or a loaded LoRA adapter)")


@pytest.fixture(scope="module")
def peft_dir(tmp_path_factory):
    """JAX's feature-matrix adapter (tests/test_feature_matrix.py lora_dir):
    q of every layer, rank 2, written by the port's safetensors writer."""
    from llm_inference_lab_tpu_torch.utils.safetensors import save_file

    cfg = LLAMA_CONFIGS["llama-tiny"]
    rng = np.random.default_rng(5)
    r, H, Dh, D = 2, cfg.n_heads, cfg.head_dim, cfg.d_model
    tensors = {}
    for i in range(cfg.n_layers):
        pre = f"base_model.model.model.layers.{i}.self_attn"
        tensors[f"{pre}.q_proj.lora_A.weight"] = torch.from_numpy(
            rng.normal(0, 0.02, (r, D)).astype(np.float32))
        tensors[f"{pre}.q_proj.lora_B.weight"] = torch.from_numpy(
            rng.normal(0, 0.02, (H * Dh, r)).astype(np.float32))
    adir = tmp_path_factory.mktemp("adapters") / "matrix-adapter"
    os.makedirs(adir, exist_ok=True)
    save_file(tensors, str(adir / "adapter_model.safetensors"))
    (adir / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": 4}))
    return str(adir)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["baseline", "vanilla", "ngram", "medusa", "eagle", "tree"])
def test_feature_matrix_lora_cells(mode, layout, peft_dir):
    """JAX's feature matrix (features.py) for lora, with its cell config
    (tests/test_feature_matrix.py _build_config): the port refuses the cells
    JAX refuses, with its message; in every other cell a request under the
    adapter through a 1-slot batcher gives its B=1 generate(adapter=...)
    ids."""
    cfg = dict(base_model="llama-tiny", draft_model="llama-tiny" if mode == "vanilla" else None,
               draft_mode="vanilla" if mode == "baseline" else mode, max_draft=2,
               max_new_tokens=4, max_seq_len=96, dtype="float32", kv_layout=layout,
               kv_page_size=16, lora_paths=[peft_dir])
    if mode == "tree":
        cfg["tree"] = {"branching": [2]}
    refused = expected_error(mode, layout, "lora")
    if refused:
        with pytest.raises(ValueError, match=refused):
            Engine(EngineConfig(**cfg), device="cpu")
        return
    eng = Engine(EngineConfig(**cfg), device="cpu")
    b = ContinuousBatcher(eng, n_slots=1)
    b.submit("matrix smoke prompt", max_new_tokens=3, lora="matrix-adapter")
    (res,) = b.run()
    assert res["generated_tokens"] > 0
    eng.config.max_new_tokens = 3
    assert res["generated_ids"] == eng.generate("matrix smoke prompt",
                                                adapter="matrix-adapter")["generated_ids"]
