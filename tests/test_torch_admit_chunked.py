"""Port parity: interleaved (chunked) admission (core/batching.py
``admit_chunk``: make_admit_incremental, _begin_incremental,
_advance_admission, _finish_admission, _abort_incremental) and serving
over the rolling-buffer cache, against the JAX package on the CPU.

tests/test_admit_chunked.py's six cases and test_kv_ring.py's
test_ring_through_batcher. The batcher cases run the JAX batcher and the
port's through the same explicit admit / step_chunk / retire calls
(test_torch_lazy_pages.py ``drive``): the per-poll slot snapshots, the stats
and each request's ids and finish reason exact, token logprobs within
1e-4; and the incremental run's ids equal the one-shot run's (and, on the
ring, the full cache's generate). The fake model is the port's
(models/fake.py); llama-tiny and mistral-tiny weights are
test_torch_decode_loop.py's (f32, projections x10).
"""

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from test_torch_lazy_pages import (drive, jax_batcher, one_thread, port_engine,  # noqa: F401
                                   reference_ids, same_gap, same_results)

LONG = "interleaved admission equivalence check " * 6  # 246 byte tokens: 4 chunks of 64
SHORT = "short req"
FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=3,
            max_new_tokens=16, max_seq_len=512)


def _fake(**kw):
    return Engine(EngineConfig(**dict(FAKE, **kw)), device="cpu")


def _incremental_against_one_shot(cfg, jb, port, reqs, n_slots):
    """JAX's batcher and the port's at admit_chunk (same calls, same
    results), and the port's one-shot run with the same ids (prompt
    logprobs within 1e-4: the chunks' forwards round apart from the whole
    prompt's)."""
    want, jtrace = drive(jb, reqs)
    b = ContinuousBatcher(port(cfg), n_slots)
    got, trace = drive(b, reqs)
    int8 = cfg.get("kv_quantization") == "int8"
    same_results(got, want, trace, jtrace, jb, b, logprobs=not int8)
    assert any(any(slot[4] for slot in t[0]) for t in trace)  # an admission went incremental
    one_shot, _ = drive(ContinuousBatcher(port(dict(cfg, admit_chunk=None)), n_slots), reqs)
    for rid, r in got.items():
        assert r["generated_ids"] == one_shot[rid]["generated_ids"], rid
        np.testing.assert_allclose(r["prompt_logprobs"][1:], one_shot[rid]["prompt_logprobs"][1:],
                                   rtol=0, atol=1e-4)
    if int8:
        jax_one_shot, _ = drive(jax_batcher(dict(cfg, admit_chunk=None), n_slots), reqs)
        same_gap(got, want, one_shot, jax_one_shot)
    return b, got


def test_incremental_equals_oneshot_contiguous():
    cfg = dict(FAKE, admit_chunk=64)
    jb = JaxBatcher(JaxEngine(JaxEngineConfig(**cfg)), n_slots=2)
    _incremental_against_one_shot(cfg, jb, lambda c: Engine(EngineConfig(**c), device="cpu"),
                                  [(SHORT, 16), (LONG, 16)], 2)


def test_incremental_equals_oneshot_paged():
    cfg = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=3, max_new_tokens=12,
               kv_layout="paged", kv_page_size=16, max_seq_len=512, dtype="float32",
               admit_chunk=64)
    b, _ = _incremental_against_one_shot(cfg, jax_batcher(cfg, 2), port_engine,
                                         [(SHORT, 12), (LONG, 12)], 2)
    assert b.allocator.free_pages == b.allocator.n_pages - 1


def test_decode_progresses_during_long_admission():
    """While the long prompt prefills chunk by chunk, the running slot
    commits tokens; the long request is parked in its slot, inactive."""
    b = ContinuousBatcher(_fake(admit_chunk=64), n_slots=2)
    b.submit(SHORT)
    b._admit_pending()
    slot0 = next(i for i, r in enumerate(b._slots) if r is not None)
    b.submit(LONG)
    b._admit_pending()  # begins the incremental admission
    pf = b._prefilling
    assert pf is not None and not bool(b.state.active[pf["slot"]])
    before = int(b.state.lengths[slot0])
    b.step_chunk(2)  # a decode chunk and ONE admission chunk
    b._retire_finished()
    assert b._prefilling is pf and pf["off"] == 64
    assert int(b.state.lengths[slot0]) > before


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cancel_mid_prefill(layout):
    """Cancelling an admission in flight unwinds it: finish_reason
    "cancelled", no admission left, every slot empty and (paged) every page
    back in the pool; a request queued behind it still runs."""
    cfg = dict(base_model="llama-tiny", draft_model=None, max_new_tokens=8, max_seq_len=512,
               dtype="float32", kv_layout=layout, kv_page_size=16, admit_chunk=64)
    b = ContinuousBatcher(port_engine(cfg), n_slots=1)
    rid = b.submit(LONG)
    b._admit_pending()
    queued = b.submit(SHORT)
    assert b._prefilling is not None
    b.step_chunk(1)
    b._retire_finished()
    assert b.cancel(rid)
    res = {r["req_id"]: r for r in b.run()}
    assert res[rid]["finish_reason"] == "cancelled" and res[rid]["generated_ids"] == []
    assert res[queued]["finish_reason"] == "length"
    assert b._prefilling is None and all(s is None for s in b._slots)
    if layout == "paged":
        assert b.allocator.free_pages == b.allocator.n_pages - 1
        assert not b.state.target_cache.table.any()


def test_cancel_decoding_and_queued():
    """A decoding request cancelled mid-flight retires at the next poll with
    what it has (finish_reason "cancelled", pages returned); a queued one is
    dropped at admission; an unknown id is refused."""
    cfg = dict(base_model="llama-tiny", draft_model=None, max_new_tokens=32, max_seq_len=256,
               dtype="float32", kv_layout="paged", kv_page_size=16, eos_token_id=-1)
    b = ContinuousBatcher(port_engine(cfg), n_slots=1)
    first, queued = b.submit("cancel me while decoding"), b.submit("never admitted")
    b._admit_pending()
    b.step_chunk(2)
    b._retire_finished()
    assert b.cancel(first) and b.cancel(queued) and not b.cancel(99)
    res = {r["req_id"]: r for r in b.run()}
    assert res[first]["finish_reason"] == res[queued]["finish_reason"] == "cancelled"
    assert 0 < len(res[first]["generated_ids"]) < 32 and res[queued]["generated_ids"] == []
    assert b.allocator.free_pages == b.allocator.n_pages - 1


def test_admit_chunk_bucket_validation():
    with pytest.raises(ValueError, match="multiple of the KV bucket"):
        ContinuousBatcher(_fake(admit_chunk=48), n_slots=2)
    with pytest.raises(ValueError, match="multiple of the KV bucket"):
        ContinuousBatcher(port_engine(dict(base_model="llama-tiny", draft_model=None,
                                           max_seq_len=256, dtype="float32", kv_layout="paged",
                                           kv_page_size=64, admit_chunk=96)), 1)


def test_short_prompts_stay_oneshot():
    b = ContinuousBatcher(_fake(admit_chunk=64), n_slots=2)
    b.submit(SHORT)
    b._admit_pending()
    assert b._prefilling is None and b.stats.admit_waves == 1
    assert any(r is not None for r in b._slots)


# ------------------------------------------------------------------- ring
RING = dict(base_model="mistral-tiny", max_seq_len=512, max_new_tokens=32, prefill_chunk=32,
            dtype="float32", kv_ring=True, admit_chunk=32, eos_token_id=-1)
# test_kv_ring.py's prompts (51 and 5 tokens) and a third of 153 tokens,
# longer than the ring of 128 (its chunks wrap the ring's scratch), which
# waits in the queue while another long admission is in flight.
RING_PROMPTS = ["ring cache check " * 3, "short", "ring cache check " * 9]


@pytest.mark.parametrize("k", [None, 3])
def test_ring_through_batcher(k):
    """mistral-tiny on its ring (128 slots; window 16), 2 slots,
    admit_chunk 32: the long prompts admit incrementally into a ring-sized
    scratch, one at a time (the 153-token one wraps it while it prefills);
    ids equal the full cache's generate and the JAX batcher's."""
    cfg = dict(RING, draft_model="mistral-tiny" if k else None, max_draft=k or 1)
    reqs = [(p, 32) for p in RING_PROMPTS]
    jb = jax_batcher(cfg, 2)
    want, jtrace = drive(jb, reqs)
    b = ContinuousBatcher(port_engine(cfg), 2)
    assert b.ring and b.state.target_cache.k.shape[3] == 128
    got, trace = drive(b, reqs)
    same_results(got, want, trace, jtrace, jb, b)
    full = reference_ids(dict(cfg, kv_ring=False), reqs)
    assert [r["generated_ids"] for r in got.values()] == full
    incremental = [slot[1] for t in trace for slot in t[0] if slot[4]]
    assert set(incremental) == {0, 2}


def test_ring_length_from_admit_chunk_equals_jax():
    """R = round_up(window + max(prefill_chunk, admit_chunk) + K + 2, 128):
    an admission chunk longer than the prefill chunk widens the ring as in
    JAX; one no longer leaves it."""
    for admit_chunk, R in ((None, 128), (32, 128), (128, 256)):
        cfg = dict(RING, draft_model="mistral-tiny", max_draft=3, admit_chunk=admit_chunk)
        eng = port_engine(cfg)
        jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg))
        assert eng.target.config.kv_ring_len == eng.draft.config.kv_ring_len == R
        assert jeng.target.config.kv_ring_len == R


# -------------------------------------------------------------- head modes
def test_eagle_carry_across_chunks_equals_one_shot():
    """EAGLE drafts from the hidden row at prompt length - 2, which an
    incremental admission takes from the chunk that holds it (here the
    third of four): the spliced carry equals the one-shot admission's
    within 1e-5, and the served ids, proposed and accepted equal JAX's."""
    cfg = dict(base_model="llama-tiny", draft_model=None, draft_mode="eagle", max_draft=2,
               max_new_tokens=12, max_seq_len=256, dtype="float32", admit_chunk=32)
    carry = []
    for chunk in (32, None):
        b = ContinuousBatcher(port_engine(dict(cfg, admit_chunk=chunk)), 1)
        b.submit("eagle carry " * 9)  # 108 tokens: the carry's row 106 is in chunk 3
        b._admit_pending()
        while b._prefilling is not None:
            b.step_chunk(1)
            b._retire_finished()
            b._admit_pending()
        carry.append(b.state.last_hidden[0].clone())
        assert torch.equal(b.state.last_hidden[0], b.state.prev_hidden[0])
    torch.testing.assert_close(carry[0], carry[1], rtol=0, atol=1e-5)
    _incremental_against_one_shot(cfg, jax_batcher(cfg, 2), port_engine,
                                  [("eagle carry " * 9, 12), (SHORT, 12)], 2)
