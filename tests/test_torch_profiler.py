"""Port parity: metrics/profiler.py (StructuredProfiler,
device_memory_stats, slope_chain_ms) and Engine.profile_phases against the
JAX package on the CPU: JAX's test_profiler.py cases on both profilers,
and a profiled generate's step and prefill counts, acceptance histogram
and phase_ms keys equal JAX's on the fake engine. No wall-clock value is
compared (JAX's own test_profile_phase_breakdown is flaky under 6
workers): only the phases' sum, which holds by construction.
"""

import json

import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.metrics.profiler import StructuredProfiler as JaxProfiler
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.metrics.profiler import (
    StructuredProfiler,
    device_memory_stats,
    slope_chain_ms,
)
from test_torch_decode_loop import one_thread  # noqa: F401

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=2,
            max_new_tokens=8, max_seq_len=256)


def test_profiler_cases_equal_jax(tmp_path):
    """JAX's test_profiler.py cases on both profilers: disabled is a no-op,
    record and aggregate, save_json, time_step, the memory keys; the
    summaries (but memory) are equal."""
    for prof in (StructuredProfiler, JaxProfiler):
        p = prof(enabled=False)
        p.record_step(5.0, accepted=2)
        p.record_prefill(10.0)
        assert p.summary()["step_ms"]["n"] == 0 and p.summary()["acceptance_histogram"] == {}
    pair = (StructuredProfiler(enabled=True), JaxProfiler(enabled=True))
    for p in pair:
        for ms, acc in [(10.0, 0), (20.0, 2), (30.0, 2)]:
            p.record_step(ms, accepted=acc)
        p.record_prefill(4.0)
    s, js = (p.summary() for p in pair)
    assert {k: v for k, v in s.items() if k != "memory"} == {k: v for k, v in js.items()
                                                             if k != "memory"}
    assert s["step_ms"]["n"] == 3 and abs(s["step_ms"]["mean"] - 20.0) < 1e-9
    assert s["acceptance_histogram"] == {0: 1, 2: 2}
    path = tmp_path / "prof.json"
    pair[0].save_json(str(path))
    assert json.load(open(path))["step_ms"]["n"] == 3
    p = StructuredProfiler(enabled=True)
    with p.time_step():
        pass
    assert p.summary()["step_ms"]["n"] == 1
    assert set(device_memory_stats().as_dict()) == {"device_mem_mb", "device_peak_mb",
                                                    "mem_rss_mb"}
    assert device_memory_stats("cpu").device_bytes_in_use is None


def test_slope_chain_restarts_each_chain_from_init():
    """slope_chain_ms runs 10 chains (a warm-up, three of lo and three of
    hi links) each from init: the carry's tensors are put back before every
    chain."""
    starts = []

    def link(params, carry):
        if carry[1].item() == 0:
            starts.append(carry[0].item())
        carry[0].add_(params)
        carry[1].add_(1)

    carry = (torch.zeros(()), torch.zeros((), dtype=torch.int64))
    slope_chain_ms(link, 2.0, carry, lo=2, hi=5)
    assert starts == [0.0] * 7


@pytest.mark.parametrize("draft", ["fake", None])
def test_profile_phases_keys_and_counts_equal_jax(draft):
    """A profiled generate on the fake engine (profile=True; with the fake
    draft, K=3, and without): the profiler's step count, prefill count and
    acceptance histogram equal JAX's observed loop's; phase_ms carries
    JAX's keys, k, batch and draft_forwards, no "error", and its parts sum
    to step_ms within the rounding; a second call is the cached one."""
    cfg = dict(FAKE, draft_model=draft, max_draft=3, max_new_tokens=12, profile=True)
    eng = Engine(EngineConfig(**cfg), device="cpu")
    jeng = JaxEngine(JaxEngineConfig(**cfg))
    got, want = eng.generate("phase attribution probe"), jeng.generate("phase attribution probe")
    assert got["generated_ids"] == want["generated_ids"]
    s, js = eng.profiler.summary(), jeng.profiler.summary()
    assert s["step_ms"]["n"] == js["step_ms"]["n"] > 0
    assert s["prefill_ms"]["n"] == js["prefill_ms"]["n"] == 1
    assert s["acceptance_histogram"] == js["acceptance_histogram"]
    ph, jph = s["phase_ms"], js["phase_ms"]
    assert "error" not in ph and set(ph) == set(jph)
    for key in ("k", "batch", "draft_forwards"):
        assert ph[key] == jph[key], key
    assert abs(ph["draft_ms"] + ph["verify_ms"] + ph["commit_sample_ms"] - ph["step_ms"]) < 1e-3
    assert eng.profile_phases() == ph
    assert s["run_metadata"]["controller"] == js["run_metadata"]["controller"]
