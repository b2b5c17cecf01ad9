"""Port parity: lazy paged allocation with preemption and resume by
recompute (core/batching.py ``kv_lazy_pages``: _plan_growth,
_apply_growth, _youngest_slot) against the JAX package on the CPU.

tests/test_lazy_pages.py's five cases. Each runs the JAX batcher and the
port's through the same explicit admit / step_chunk / retire calls
(``drive``, chunks of POLL_EVERY steps): the slots' page ids, reuse lengths,
the pool's free count and the growth and preemption counts after every
poll, the stats and each request's ids and finish reason are exact, token
logprobs within 1e-4; and every request's ids equal an uninterrupted B=1
``generate`` of its prompt. The port runs on its decode loop and on the
host step (``EnvFlags(sync_steps=True)``). Weights: test_torch_decode_loop.py's
llama-tiny (f32, projections x10) carried over with convert.params_from_jax.

The helpers here (``drive``, ``jax_batcher``, ``port_engine``,
``same_results``) serve test_torch_prefix_cache.py and
test_torch_admit_chunked.py too.
"""

import functools

import numpy as np
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import POLL_EVERY, ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from test_torch_decode_loop import SYNC, _pair, one_thread  # noqa: F401

STATS = ("admitted", "retired", "admit_waves", "page_grows", "preemptions")



def _models(cfg):
    target, draft = _pair(cfg["base_model"])
    vanilla = cfg.get("draft_model") and cfg.get("draft_mode", "vanilla") == "vanilla"
    return target, draft if vanilla else None


def jax_batcher(cfg, n_slots):
    target, draft = _models(cfg)
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     draft_model=draft)
    return JaxBatcher(jeng, n_slots=n_slots)


def port_engine(cfg, flags=None):
    target, draft = _models(cfg)
    return Engine(EngineConfig(**cfg), device="cpu", flags=flags,
                  target_params=params_from_jax(target.params),
                  draft_params=params_from_jax(draft.params) if draft is not None else None)


def snapshot(b):
    """After a poll and its admissions: each occupied slot's request, page
    ids, reuse length and incremental state; the pool's free pages; the
    growth and preemption counts."""
    slots = tuple((s, r.req_id, tuple(r.pages or ()), r.reuse_len, r.prefilling)
                  for s, r in enumerate(b._slots) if r is not None)
    free = b.allocator.free_pages if b.allocator is not None else None
    return slots, free, b.stats.page_grows, b.stats.preemptions


def drive(b, reqs, chunk=POLL_EVERY, limit=500):
    """Submit (prompt, budget) pairs, then admit, and step_chunk(chunk) /
    retire / admit until every slot is empty and the queue drained. Returns
    the submitted requests' results and the snapshots after each poll."""
    rids = [b.submit(p, max_new_tokens=m) for p, m in reqs]
    b._admit_pending()
    trace = [snapshot(b)]
    for _ in range(limit):
        if not any(s is not None for s in b._slots) and not b.scheduler.pending():
            break
        b.step_chunk(chunk)
        b._retire_finished()
        b._admit_pending()
        trace.append(snapshot(b))
    assert not b.scheduler.pending() and not any(s is not None for s in b._slots)
    return {rid: b._done[rid].result for rid in rids}, trace


def same_results(got, want, trace, jtrace, jb, b, logprobs=True):
    """Port against JAX: the per-poll snapshots, the stats, and per request
    ids, finish reason, reused prompt tokens (exact), token logprobs (1e-4)
    and prompt logprobs (None at the same positions; the values within
    1e-4 + 3e-5 |lp|, test_torch_serving's tolerance; logprobs=False leaves
    the values to the caller). Proposed and accepted are equal for a
    request never preempted (the port's result also counts the slots a
    preemption took, JAX's only the last)."""
    assert trace == jtrace
    assert [getattr(b.stats, k) for k in STATS] == [getattr(jb.stats, k) for k in STATS]
    assert sorted(got) == sorted(want)
    for rid, r in got.items():
        w = want[rid]
        for key in ("generated_ids", "finish_reason", "generated_tokens"):
            assert r[key] == w[key], (rid, key, r[key], w[key])
        if w["finish_reason"] == "cancelled":
            continue
        assert r["prompt_tokens_reused"] == w["prompt_tokens_reused"], rid
        if b._done[rid].resume_ids is None:
            assert (r["proposed"], r["accepted"]) == (w["proposed"], w["accepted"]), rid
        lp, wlp = r["prompt_logprobs"], w["prompt_logprobs"]
        assert [x is None for x in lp] == [x is None for x in wlp], rid
        if not logprobs:
            continue
        np.testing.assert_allclose(r["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
        np.testing.assert_allclose([x for x in lp if x is not None],
                                   [x for x in wlp if x is not None], rtol=3e-5, atol=1e-4)


# same_gap's tolerance: ULPS f32 ulps of each of the four logprobs in a gap
# of gaps (each is logit - logsumexp of an f32 forward whose summation order
# the admission route changes), at magnitude 1 at least (the logsumexp a
# logprob near 0 comes from is not smaller), plus the 6-decimal rounding of
# the results, half a unit in the 6th place for each of the four.
ULPS = 8
ROUND_6 = 5e-7


def gap_tolerance(*vals):
    """The atol of | |a - b| - |c - d| | for the four logprobs a..d
    (arrays of one shape): ULPS * sum of np.spacing(f32 max(|v|, 1)) +
    4 * ROUND_6."""
    ulps = sum(np.spacing(np.maximum(np.abs(v), 1.0).astype(np.float32)).astype(float)
               for v in vals)
    return ULPS * ulps + len(vals) * ROUND_6


def same_gap(got, want, base, base_want):
    """Over int8 pools the two packages' logprobs part where an f32 row
    rounds to another int8 step (up to 1.1e-3 on these weights, in the
    port's and JAX's plain one-shot serving alike): the feature under test
    must add no gap of its own. Per request, |got - want| equals
    |base - base_want| within gap_tolerance of the four values, token
    logprobs and the prompt logprobs got scores (not those a prefix cache
    served)."""
    def values(r, key):
        return np.array([np.nan if x is None else x for x in r[key]], float)

    for rid, r in got.items():
        for key in ("token_logprobs", "prompt_logprobs"):
            scored = ~np.isnan(values(r, key))
            four = [values(d[rid], key)[scored] for d in (got, want, base, base_want)]
            gap, base_gap = np.abs(four[0] - four[1]), np.abs(four[2] - four[3])
            excess = np.abs(gap - base_gap) - gap_tolerance(*four)
            assert np.all(excess <= 0), (rid, key, float(excess.max()))


def reference_ids(cfg, reqs):
    """Each prompt alone through the port's Engine.generate (contiguous
    cache, its own budget): the uninterrupted ids."""
    out = []
    for prompt, budget in reqs:
        eng = port_engine(dict(cfg, kv_layout="contiguous", kv_pages=None, prefix_caching=False,
                               max_new_tokens=budget))
        out.append(eng.generate(prompt)["generated_ids"])
    return out


# No EOS (-1 is never sampled), so every request runs its whole budget.
LAZY = dict(base_model="llama-tiny", draft_model=None, max_draft=2, max_new_tokens=48,
            max_seq_len=256, dtype="float32", kv_layout="paged", kv_page_size=16,
            eos_token_id=-1)
# (config, requests, slots) of tests/test_lazy_pages.py's cases.
CASES = {
    "admits": (dict(LAZY, kv_pages=8), [("lazy pages alpha", 48), ("lazy pages beta", 48)], 2),
    "grows": (LAZY, [("grow check one", 48), ("grow check two longer prompt", 48)], 2),
    "preempts": (dict(LAZY, kv_pages=8),
                 [("preempt victim check", 48), ("preempt survivor check", 48)], 2),
    "footprint": (dict(LAZY, max_new_tokens=128), [("tiny prompt", 128)], 2),
    "prefix": (dict(LAZY, max_seq_len=512, kv_pages=16, prefix_caching=True),
               [("common system prefix " * 8 + "tail A", 48),
                ("common system prefix " * 8 + "tail B", 48)], 2),
    # test_torch_serving_paths.py: a draft model (K=2) over int8 pools (the
    # resumed request's draft cache and int8 scales are recomputed too), and
    # the tree (num_nodes + 1 = 10 rows a step, a growth margin of 100).
    "preempts int8 spec": (dict(LAZY, kv_pages=10, draft_model="llama-tiny",
                                kv_quantization="int8"),
                           [("preempt victim check", 48), ("preempt survivor check", 48)], 2),
    "preempts tree": (dict(LAZY, kv_pages=19, max_seq_len=512, max_new_tokens=120,
                           draft_mode="tree", tree={"branching": [3, 2]}),
                      [("preempt victim check", 120), ("preempt survivor check", 120)], 2),
}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    cfg, reqs, n_slots = CASES[case]
    jb = jax_batcher(cfg, n_slots)
    return (jb, *drive(jb, reqs))


@functools.lru_cache(maxsize=None)
def _reference(case):
    cfg, reqs, _ = CASES[case]
    return reference_ids(cfg, reqs)


def _serve(case, flags):
    """The case through the port (loop or host step) and JAX; checks parity
    and the uninterrupted ids; returns the port's batcher and results."""
    cfg, reqs, n_slots = CASES[case]
    jb, want, jtrace = _jax_run(case)
    b = ContinuousBatcher(port_engine(cfg, flags), n_slots)
    got, trace = drive(b, reqs)
    same_results(got, want, trace, jtrace, jb, b)
    for rid, ids in enumerate(_reference(case)):
        assert got[rid]["generated_ids"] == ids, rid
    assert list(b.allocator._free) == list(jb.allocator._free)
    return b, got, trace


FLAGS = {"loop": None, "host step": SYNC}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_lazy_admits_where_eager_refuses(flags):
    """A pool of 7 usable pages holds one worst-case reservation (16 + 48 +
    K + 2 = 68 tokens: 5 pages), not two: eager admission runs one request,
    lazy both from the start, and every page comes back."""
    cfg, reqs, _ = CASES["admits"]
    for eager in (ContinuousBatcher(port_engine(dict(cfg, kv_lazy_pages=False), FLAGS[flags]), 2),
                  jax_batcher(dict(cfg, kv_lazy_pages=False), 2)):
        for p, m in reqs:
            eager.submit(p, max_new_tokens=m)
        eager._admit_pending()
        assert sum(s is not None for s in eager._slots) == 1
    b, got, trace = _serve("admits", FLAGS[flags])
    assert len(trace[0][0]) == 2
    assert b.allocator.free_pages == 7


@pytest.mark.parametrize("flags", list(FLAGS))
def test_growth_without_preemption_matches_eager(flags):
    """A roomy pool: pages grow (page_grows > 0), nothing is preempted, and
    the ids equal the eager batcher's."""
    b, got, _ = _serve("grows", FLAGS[flags])
    assert b.stats.page_grows > 0 and b.stats.preemptions == 0
    cfg, reqs, _ = CASES["grows"]
    eager, _ = drive(ContinuousBatcher(port_engine(dict(cfg, kv_lazy_pages=False)), 2), reqs)
    assert [r["generated_ids"] for r in got.values()] == [
        r["generated_ids"] for r in eager.values()]


def check_preemption(case, flags):
    """A pool too small for both requests' growth: the youngest slot is
    preempted mid-decode, requeued with its prompt + generated tokens, and
    resumes by recompute to the uninterrupted ids; every page returns."""
    b, got, trace = _serve(case, flags)
    assert b.stats.preemptions >= 1
    assert any(r.resume_ids is not None for r in b._done.values())
    assert b.allocator.free_pages == CASES[case][0]["kv_pages"] - 1


@pytest.mark.parametrize("flags", list(FLAGS))
def test_preemption_resumes_by_recompute(flags):
    """check_preemption on the baseline (the other serving paths:
    test_torch_serving_paths.py)."""
    check_preemption("preempts", FLAGS[flags])


@pytest.mark.parametrize("flags", list(FLAGS))
def test_lazy_serving_memory_is_live_tokens(flags):
    """Admission reserves the prompt + the growth margin (2 * POLL_EVERY *
    1 + K + 2 = 12 tokens here): 2 pages, not the worst case's 9."""
    b, got, trace = _serve("footprint", FLAGS[flags])
    (slot,) = trace[0][0]
    assert len(slot[2]) <= 3, slot
    assert b._grow_margin == 2 * POLL_EVERY + 2 + 2


@pytest.mark.parametrize("flags", list(FLAGS))
def test_preemption_with_prefix_caching(flags):
    """Preempting a request that shares prefix pages unwinds its refcounts
    and resumes to the uninterrupted ids."""
    b, got, _ = _serve("prefix", FLAGS[flags])
    assert b.allocator.hits > 0 and b.stats.preemptions >= 1
