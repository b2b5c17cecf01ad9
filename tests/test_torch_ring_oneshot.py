"""Port parity: serving over the rolling-buffer cache without incremental
admission (core/batching.py: the ring's one-shot wave and
``_admit_long_ring``) against the JAX package on the CPU.

mistral-tiny on its ring (R = 128 slots, window 16, prefill_chunk 32, no
admit_chunk) through 2 slots, at K = None (baseline) and K = 3 (a
mistral-tiny draft), over the model's f32 KV cache and an int8 one; the
prompts are test_torch_admit_chunked.py's RING_PROMPTS (51, 5 and 153 byte
tokens). Weights: test_torch_decode_loop.py's (f32, projections x10),
carried over with convert.params_from_jax. Both packages' batchers run
through the same explicit admit / step_chunk / retire calls
(test_torch_lazy_pages.py ``drive``).

* The two short prompts (32-padded length P <= R) are admitted one-shot as
  JAX admits them: the per-poll slot snapshots, the stats and each
  request's ids and finish reason equal JAX's batcher, token and prompt
  logprobs within test_torch_lazy_pages.same_results' tolerance (f32).
* The 153-token prompt (P = 160 > R) is admitted one-shot in 5 forwards of
  32 rows through a ring-sized scratch, back to back: its ids equal JAX's
  ring Engine.generate and the full cache's, its prompt logprobs JAX's
  incremental admission's (the same chunks).
* JAX's own one-shot admission past R, pinned: its batcher's wave raises in
  its splice (a scratch of 256 slots into a lane of 128), and its
  single-slot make_admit gives its generate's ids but prompt logprobs that
  are off by more than 1 at the early positions (their keys were
  overwritten by positions 128 later within the one forward; mistral-tiny's
  2 layers x window 16 keep the damage from the ids).
* A poll holding a short and a long prompt admits the short one in a wave
  and the long one alone, before any decode step.
* MultiHostBatcher in one process (incremental admission off, as JAX has
  it) serves the ring one-shot with admit_chunk set. Its several-rank runs
  (data=2, model=2) are in test_torch_mesh_serving.py's launch.
"""

import numpy as np
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.multihost_batching import MultiHostBatcher
from test_torch_admit_chunked import RING, RING_PROMPTS
from test_torch_lazy_pages import (_models, drive, jax_batcher, one_thread,  # noqa: F401
                                   port_engine, reference_ids, same_results)

pytestmark = pytest.mark.usefixtures("one_thread")

SHORT, LONG = RING_PROMPTS[:2], RING_PROMPTS[2]
BUDGET = 32


def _cfg(k, kv):
    return dict(RING, admit_chunk=None, draft_model="mistral-tiny" if k else None,
                max_draft=k or 1, kv_quantization=kv)


def _jax_generate(cfg, prompt):
    target, draft = _models(cfg)
    eng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                    draft_model=draft)
    return eng.generate(prompt)["generated_ids"]


def _lp(r):
    return np.array([np.nan if x is None else x for x in r["prompt_logprobs"]], float)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("k", [None, 3], ids=["baseline", "k3"])
def test_short_ring_prompts_equal_jax_batcher(k, kv):
    """P <= R: the port's batcher without admit_chunk gives JAX's batcher's
    snapshots, stats, ids and finish reasons (and logprobs over f32 KV)."""
    cfg = _cfg(k, kv)
    reqs = [(p, BUDGET) for p in SHORT]
    jb = jax_batcher(cfg, 2)
    want, jtrace = drive(jb, reqs)
    b = ContinuousBatcher(port_engine(cfg), 2)
    assert b.ring and b.admit_chunk is None and b.state.target_cache.k.shape[3] == 128
    got, trace = drive(b, reqs)
    same_results(got, want, trace, jtrace, jb, b, logprobs=kv is None)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("k", [None, 3], ids=["baseline", "k3"])
def test_long_ring_prompt_equals_generate(k, kv):
    """P > R: the three prompts through 2 slots; the 153-token one's ids
    equal JAX's ring generate and the port's full-cache generate, and no
    admission spans a poll. Over f32 KV its prompt logprobs equal JAX's
    incremental admission's (admit_chunk 32: the same chunks) within
    same_results' tolerance."""
    cfg = _cfg(k, kv)
    reqs = [(p, BUDGET) for p in RING_PROMPTS]
    got, trace = drive(ContinuousBatcher(port_engine(cfg), 2), reqs)
    assert not any(slot[4] for t in trace for slot in t[0])
    full = reference_ids(dict(cfg, kv_ring=False), reqs)
    assert [r["generated_ids"] for r in got.values()] == full
    assert got[2]["generated_ids"] == _jax_generate(cfg, LONG)
    if kv is None:
        inc, _ = drive(jax_batcher(dict(cfg, admit_chunk=32), 2), reqs)
        np.testing.assert_allclose(_lp(got[2])[1:], _lp(inc[2])[1:], rtol=3e-5, atol=1e-4)


def test_jax_one_shot_ring_admission_past_R_is_its_fault():
    """Settled: JAX's one-shot admission of a ring prompt longer than the
    ring is at fault. Its batcher's route without admit_chunk (the wave,
    make_admit_many) raises: the [1, 256] scratch does not fit the lane of
    128. Its single-slot make_admit (a ring-sized scratch, one [1, 160]
    forward) gives its generate's ids, but positions p and p + 128 share a
    slot within the forward, so early queries read later keys: its prompt
    logprobs are off by more than 1 from its incremental admission's (the
    port's one-shot route gives the latter, test above)."""
    cfg = _cfg(None, None)
    jb = jax_batcher(cfg, 2)
    jb.submit(LONG, max_new_tokens=BUDGET)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jb._admit_pending()
    jb = jax_batcher(cfg, 2)
    jb._execute_admissions = lambda mark_fresh=False: [
        jb._admit_one(req.slot, req) for req in jb._plan_admissions()]
    one_shot, _ = drive(jb, [(LONG, BUDGET)])
    inc, _ = drive(jax_batcher(dict(cfg, admit_chunk=32), 2), [(LONG, BUDGET)])
    assert one_shot[0]["generated_ids"] == inc[0]["generated_ids"] == _jax_generate(cfg, LONG)
    gap = np.abs(_lp(one_shot[0])[1:] - _lp(inc[0])[1:])
    assert gap.max() > 1.0
    assert np.all(gap[127:] <= 1e-4)  # positions past R read no overwritten key


def test_short_wave_and_long_alone_in_one_poll():
    """A poll that holds a short and a long prompt: the short one is one
    wave, the long one is admitted alone in P / C = 5 forwards, and both
    slots decode before any step ran; the ids equal the full cache's."""
    cfg = _cfg(3, None)
    b = ContinuousBatcher(port_engine(cfg), 2)
    chunks = []
    run_chunk = b._prefill_chunk
    b._prefill_chunk = lambda pf, fn: chunks.append(pf["off"]) or run_chunk(pf, fn)
    reqs = [(SHORT[1], BUDGET), (LONG, BUDGET)]
    for prompt, budget in reqs:
        b.submit(prompt, max_new_tokens=budget)
    b._admit_pending()
    assert (b.stats.admitted, b.stats.admit_waves, b._steps) == (2, 1, 0)
    assert chunks == [0, 32, 64, 96, 128]
    assert b.state.active.tolist() == [True, True] and b._prefilling is None
    got = b.run()
    assert [r["generated_ids"] for r in got] == reference_ids(dict(cfg, kv_ring=False), reqs)


def test_multihost_in_one_process_admits_the_ring_one_shot():
    """MultiHostBatcher turns incremental admission off (JAX's switch): with
    admit_chunk 32 set, the ring's prompts are admitted one-shot, and every
    request's ids equal ContinuousBatcher's incremental run's."""
    cfg = dict(_cfg(3, None), admit_chunk=32)
    reqs = [(p, BUDGET) for p in RING_PROMPTS]
    b = MultiHostBatcher(port_engine(cfg), 2)
    assert b.admit_chunk is None and b._admit_incr is not None
    got, trace = drive(b, reqs)
    assert not any(slot[4] for t in trace for slot in t[0])
    want, _ = drive(ContinuousBatcher(port_engine(cfg), 2), reqs)
    assert [r["generated_ids"] for r in got.values()] == [
        r["generated_ids"] for r in want.values()]
