"""Port parity: the bench harness (bench/k_sweep.py, run_bench.py,
stress.py, quality_eval.py) against the JAX package's on the CPU.

On the fake model and on llama-tiny (test_torch_decode_loop.py's pair,
whose draft accepts part of the time; JAX's models carried across by
convert.params_from_jax and handed to both packages' engines) the port's
results equal JAX's in their keys and, timings excluded, exactly in
generated ids and tokens, acceptance, steps, completions and success
rates; the dry run gives JAX's synthetic numbers; save_results writes
JAX's CSV header and rows (timing columns excluded). Perplexity on
llama-tiny in f32 is held to JAX's within 1e-5 relative (f32 sums over V =
256 in another order), the int8 and int4 deltas to JAX's within 1e-5 of
the f32 perplexity, and both meet JAX's gates (tests/test_quant_quality.py:
under 2% for int8, 15% for int4).
"""

import csv
import dataclasses
import functools
import glob

import jax
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.bench import k_sweep as jax_sweep
from llm_inference_lab_tpu.bench import quality_eval as jax_quality
from llm_inference_lab_tpu.bench import run_bench as jax_bench
from llm_inference_lab_tpu.bench import stress as jax_stress
from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models.llama import LlamaModel
from llm_inference_lab_tpu.ops.quant import quantize_params as jax_quantize_params
from llm_inference_lab_tpu_torch.bench import k_sweep, quality_eval, run_bench, stress
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models.llama import create as create_llama
from test_torch_decode_loop import _pair, one_thread  # noqa: F401

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake")
TINY = dict(implementation="hf", base_model="llama-tiny", draft_model="llama-tiny")
PROMPTS = ["a", "bb", "the quick brown fox", "sweep prompt four"]
TIMINGS = {"tokens_per_sec", "generation_time_ms", "aggregate_tokens_per_sec",
           "step_latency_ms", "latency_ms", "setup_s"}


@pytest.fixture
def tiny_weights(monkeypatch):
    """Both packages' bench modules build their engines on llama-tiny's JAX
    pair (the port's through params_from_jax)."""
    target, draft = _pair("llama-tiny")
    tp, dp = params_from_jax(target.params), params_from_jax(draft.params)

    def port_engine(cfg, **kw):
        return Engine(cfg, target_params=tp, draft_params=dp if cfg.draft_model else None, **kw)

    def jax_engine(cfg, **kw):  # JAX's engine drafts with a given draft model whatever the config
        return JaxEngine(cfg, target_model=target, draft_model=draft if cfg.draft_model else None,
                         **kw)

    for module in (k_sweep, run_bench):
        monkeypatch.setattr(module, "Engine", port_engine)
    for module in (jax_sweep, jax_bench):
        monkeypatch.setattr(module, "Engine", jax_engine)
    return target, draft


def _without_timings(row):
    return {k: v for k, v in row.items() if k not in TIMINGS}


def _same_sweep(got, want):
    assert set(got) == set(want) and got["config"] == want["config"]
    assert set(got["system_info"]) - {"torch_version"} == set(want["system_info"]) - {
        "jax_version"}
    assert set(got["summary_results"]) == set(want["summary_results"])
    for k, row in want["summary_results"].items():
        mine = got["summary_results"][k]
        assert set(mine) - {"setup_s"} == set(row), k
        assert _without_timings(mine) == _without_timings(row), k
    assert ([_without_timings(d) for d in got["detailed_results"]]
            == [_without_timings(d) for d in want["detailed_results"]])


@pytest.mark.parametrize("kind,batch_size", [("fake", 2), ("tiny", 0)])
def test_k_sweep_equals_jax(kind, batch_size, request, tmp_path):
    """run_k_sweep's summary and per-request records (timings excluded),
    and save_results' CSV apart from the timing columns."""
    kw = dict(max_k=2, max_new_tokens=8, iterations=2, batch_size=batch_size, prompts=PROMPTS)
    if kind == "fake":
        models = FAKE
    else:
        request.getfixturevalue("tiny_weights")
        models = dict(TINY, max_seq_len=256, dtype="float32")
    port_models = dict(models)
    extra = {k: port_models.pop(k) for k in ("max_seq_len", "dtype") if k in port_models}
    want = jax_sweep.run_k_sweep(**kw, **port_models, output_dir=str(tmp_path / "jax"))
    got = k_sweep.run_k_sweep(**kw, **port_models, output_dir=str(tmp_path / "port"),
                              device="cpu", **extra)
    _same_sweep(got, want)
    assert all(row["success_rate"] == 1.0 for row in got["summary_results"].values())
    if kind == "tiny":
        assert 0 < got["summary_results"]["k=2"]["acceptance_rate"]["mean"] < 1
    rows = {}
    for side in ("jax", "port"):
        (path,) = glob.glob(str(tmp_path / side / "*.csv"))
        with open(path) as f:
            rows[side] = list(csv.reader(f))
        assert glob.glob(str(tmp_path / side / "*.json"))
    assert rows["port"][0] == rows["jax"][0]
    keep = [i for i, name in enumerate(rows["jax"][0])
            if not name.startswith(("tok_s", "step_latency"))]
    assert ([[r[i] for i in keep] for r in rows["port"]]
            == [[r[i] for i in keep] for r in rows["jax"]])


def test_k_sweep_dry_run_and_failures_equal_jax(monkeypatch):
    """The dry run's synthetic numbers exactly (JAX's SPECDX_DRY_RUN is
    the port's EnvFlags(dry_run=True)), and a K whose engine fails records
    success_rate 0 and the error in both."""
    monkeypatch.setenv("SPECDX_DRY_RUN", "1")
    want = jax_sweep.run_k_sweep(implementation="fake", max_k=3)
    monkeypatch.delenv("SPECDX_DRY_RUN")
    got = k_sweep.run_k_sweep(implementation="fake", max_k=3, device="cpu",
                              flags=EnvFlags(dry_run=True))
    assert got["summary_results"] == want["summary_results"]
    assert got["system_info"]["env_flags"]["dry_run"] is True
    bad = dict(FAKE, max_k=2, max_new_tokens=4, iterations=1, prompts=PROMPTS[:1],
               policy="no_such_policy")
    want, got = jax_sweep.run_k_sweep(**bad), k_sweep.run_k_sweep(**bad, device="cpu")
    for k, row in want["summary_results"].items():
        mine = got["summary_results"][k]
        assert set(mine) == set(row) and mine["success_rate"] == row["success_rate"] == 0.0
        assert "no_such_policy" in mine["error"]


def test_system_info_names_what_runs():
    """On the CPU every kernel op runs its plain version and the MoE block
    PyTorch ops; the keys are JAX's with torch_version for jax_version."""
    info = k_sweep.system_info("cpu")
    assert info["backend"] == "cpu" and "power_limit" not in info
    assert set(info["kernel_backends"]) == {"quant_matmul", "verify_prefix", "decode_attention",
                                            "prefill_attention", "paged_attention", "rms_norm",
                                            "tied_head", "kv_write", "moe_mlp"}
    assert {v for k, v in info["kernel_backends"].items() if k != "moe_mlp"} == {"plain"}
    assert info["kernel_backends"]["moe_mlp"] == "torch"


@pytest.mark.parametrize("kind", ["fake", "tiny"])
def test_compare_to_baseline_equals_jax(kind, request):
    """compare_to_baseline: both runs' keys and acceptance; the baseline
    proposes nothing. Timings (and the speedup they give) excluded."""
    if kind == "fake":
        models = dict(FAKE, max_draft=2)
    else:
        request.getfixturevalue("tiny_weights")
        models = dict(TINY, max_draft=2, max_seq_len=256, dtype="float32")
    kw = dict(iterations=2, warmup=1)
    want = jax_bench.BenchmarkRunner(mode="specdec", **kw, **models).compare_to_baseline(
        PROMPTS[2:], max_new_tokens=8)
    runner = run_bench.BenchmarkRunner(mode="specdec", device="cpu", **kw, **models)
    got = runner.compare_to_baseline(PROMPTS[2:], max_new_tokens=8)
    assert set(got) == set(want)
    for side in ("specdec", "baseline"):
        assert set(got[side]) == set(want[side])
        assert _without_timings(got[side]) == _without_timings(want[side]), side
    assert got["baseline"]["acceptance_rate"]["mean"] == 0.0
    assert got["speedup"] > 0
    # max_new_tokens is the call's budget, as JAX's generate takes it.
    r = runner.engine.generate(PROMPTS[2], max_new_tokens=5)
    assert r["generated_tokens"] <= 5 and runner.engine.config.max_new_tokens == 64


def _stress_pair(kind):
    """(JAX batcher, port batcher, StressConfig keywords)."""
    if kind == "fake":
        kw = dict(FAKE, max_draft=2, max_new_tokens=32, max_seq_len=256)
        jeng = JaxEngine(JaxEngineConfig(**kw))
        eng = Engine(EngineConfig(**kw), device="cpu")
        return (JaxBatcher(jeng, n_slots=4), ContinuousBatcher(eng, n_slots=4),
                dict(total_requests=40, n_slots=4, prompt_len_cap=120))
    # JAX's test_stress_churn_paged: a pool below slots x max_seq.
    make = functools.partial(LlamaModel.create, "llama-tiny", dtype=jax.numpy.float32)
    target, draft = make(rng=jax.random.PRNGKey(0)), make(rng=jax.random.PRNGKey(1))
    kw = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2, max_new_tokens=16,
              max_seq_len=256, dtype="float32", kv_layout="paged", kv_page_size=32,
              kv_pages=3 * (256 // 32))
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **kw), target_model=target,
                     draft_model=draft)
    eng = Engine(EngineConfig(**kw), device="cpu", target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params))
    return (JaxBatcher(jeng, n_slots=4), ContinuousBatcher(eng, n_slots=4),
            dict(total_requests=30, n_slots=4, prompt_len_cap=100,
                 max_new_choices=(2, 4, 8, 16)))


@pytest.mark.parametrize("kind", ["fake", "tiny paged"])
def test_stress_equals_jax(kind):
    """run_stress under churn: the report's keys, completions, submissions,
    decode steps, polls, tokens and all_nonempty equal JAX's, and every
    request's ids; device memory is None on the CPU."""
    jb, b, kw = _stress_pair(kind.split()[0])
    want = jax_stress.run_stress(None, jax_stress.StressConfig(**kw, max_wall_s=240.0),
                                 batcher=jb)
    got = stress.run_stress(None, stress.StressConfig(**kw, max_wall_s=240.0), batcher=b)
    assert set(got) == set(want)
    for key in ("completed", "submitted", "total_requested", "decode_steps", "polls", "tokens",
                "all_nonempty"):
        assert got[key] == want[key], key
    assert got["completed"] == kw["total_requests"] and got["all_nonempty"]
    assert got["device_mem_growth_mb"] is None
    assert ([b._done[r].result["generated_ids"] for r in sorted(b._done)]
            == [jb._done[r].result["generated_ids"] for r in sorted(jb._done)])


@pytest.fixture(scope="module")
def fp_pair():
    """llama-tiny in f32 (JAX's test_quant_quality tiny(): PRNGKey(3)) in
    both packages, and ids from a seed (3 rows of 24)."""
    jm = LlamaModel.create("llama-tiny", rng=jax.random.PRNGKey(3), dtype=jax.numpy.float32)
    pm = create_llama("llama-tiny", device="cpu", dtype=torch.float32,
                      params=params_from_jax(jm.params))
    rng = np.random.default_rng(0)
    return jm, pm, [rng.integers(1, 255, (24,)).tolist() for _ in range(3)]


def _jax_clone(model, mode):
    """JAX's quantized model without touching the original (JAX's
    quantize_params replaces leaves in place: the tree is copied first)."""
    m = dataclasses.replace(model)
    m.params = jax_quantize_params(jax.tree_util.tree_map(lambda a: a, model.params), mode,
                                   min_size=1024)
    return m


def test_perplexity_ids_equals_jax(fp_pair):
    """Each row's perplexity within 1e-5 relative of JAX's; a row of fewer
    than 2 ids is NaN, as JAX's; compare's keys are JAX's."""
    jm, pm, rows = fp_pair
    ev, jev = quality_eval.PerplexityEvaluator(pm), jax_quality.PerplexityEvaluator(jm)
    for ids in rows + [rows[0][:2], list(range(1, 200))]:
        got, want = ev.perplexity_ids(ids), jev.perplexity_ids(ids)
        assert got > 1.0 and abs(got - want) <= 1e-5 * want, (got, want)
    assert np.isnan(ev.perplexity_ids([5]))
    assert set(ev.compare(["ab", "cd"], _Bytes())) == {"perplexities", "mean", "n"}


class _Bytes:
    def encode(self, text):
        return [1 + b for b in text.encode()]


@pytest.mark.parametrize("mode,gate", [("int8", 0.02), ("int4", 0.15)])
def test_perplexity_delta_equals_jax_and_meets_gate(fp_pair, mode, gate):
    """The quantized clone's perplexity delta equals JAX's (the same bytes
    through both forwards) within 1e-5 of the f32 perplexity, differs from
    0 (the clone is quantized, the original not), and meets JAX's gate."""
    jm, pm, rows = fp_pair
    want = jax_quality.perplexity_delta(jm, _jax_clone(jm, mode), rows)
    clone = quality_eval.quantized_clone(pm, mode)
    got = quality_eval.perplexity_delta(pm, clone, rows)
    tol = 1e-5 * want["ppl_a"]
    for key in ("ppl_a", "ppl_b", "delta"):
        assert abs(got[key] - want[key]) <= tol, (key, got, want)
    assert got["delta"] != 0.0 and abs(got["delta"]) / got["ppl_a"] < gate
    assert type(pm.params["layers"]["w_qkv"]).__name__ == "Tensor"  # the original stays f32


def test_jax_quality_gate_compares_the_clone_with_itself(fp_pair):
    """JAX's fault, pinned: tests/test_quant_quality.py's quantized_clone
    quantizes model.params in place (quantize_params replaces leaves in the
    tree it is given), so its gates compare the quantized model with
    itself (delta 0). The port's clone copies the tree first."""
    rows = fp_pair[2]
    jm = LlamaModel.create("llama-tiny", rng=jax.random.PRNGKey(3), dtype=jax.numpy.float32)
    clone = dataclasses.replace(jm)
    clone.params = jax_quantize_params(jm.params, "int8", min_size=1024)
    assert jax_quality.perplexity_delta(jm, clone, rows)["delta"] == 0.0
