"""Port parity: continuous-batching serving (core/scheduler.py and
core/batching.py ContinuousBatcher) against the JAX package on the CPU,
plus the port's counterparts of tests/test_paged.py's serving checks.

The JAX batcher's own loop times its polls with a cost model and lagged
snapshots, so the slots and admission waves a request gets depend on wall
time. Which slot a request lands in changes its drafts after a full accept
(the draft-cache hole the port keeps for parity, ROADMAP Queue 3), so the
batcher parity test drives both batchers through their own admit / step /
retire methods, one step per poll: both then admit the same requests into
the same slots at the same steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.native import NativeScheduler
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.scheduler import Scheduler
from test_torch_decode_loop import one_thread  # noqa: F401


@pytest.mark.parametrize("length_bucket,max_wait,seed", [(32, 64, 0), (16, 2, 1), (8, 0, 2),
                                                         (64, 1, 3)])
def test_scheduler_matches_jax_python_path(length_bucket, max_wait, seed):
    """Random submit/admit sequences: the same ids in the same order as JAX
    NativeScheduler(force_python=True), with max_wait small enough that the
    overdue rule decides many rounds."""
    rng = np.random.default_rng(seed)
    ours = Scheduler(length_bucket=length_bucket, max_wait=max_wait)
    ref = NativeScheduler(length_bucket=length_bucket, max_wait=max_wait, force_python=True)
    rid = 0
    for _ in range(400):
        if rng.random() < 0.55:
            plen = int(rng.choice([rng.integers(0, 40), rng.integers(0, 600)]))
            ours.submit(rid, plen, 16)
            ref.submit(rid, plen, 16)
            rid += 1
        else:
            n = int(rng.integers(1, 5))
            assert ours.admit(n) == ref.admit(n)
        assert ours.pending() == ref.pending()


def test_scheduler_overdue_request_goes_first():
    """A long request alone in its bucket waits while the crowded short
    bucket is served, until it has waited more than max_wait rounds."""
    s = Scheduler(length_bucket=32, max_wait=2)
    s.submit(0, 500, 8)
    for i in range(1, 9):
        s.submit(i, 10, 8)
    assert s.admit(1) == [1]
    assert s.admit(1) == [2]
    assert s.admit(1) == [0]  # three rounds old > max_wait: overdue
    assert s.admit(2) == [3, 4]


def _tiny(seed: int, mix_with: int = None):
    """llama-tiny from the JAX factory, weights scaled x10 so greedy
    generation is not a constant token; the draft mixes in a second model so
    it agrees with the target only some of the time."""
    def make(s):
        m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(s), dtype=jnp.float32)
        return jax.tree_util.tree_map(lambda a: a * 10 if a.ndim >= 2 else a, m.params)

    m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
    m.params = make(seed)
    if mix_with is not None:
        other = make(mix_with)
        m.params = jax.tree_util.tree_map(lambda a, b: 0.95 * a + 0.05 * b, m.params, other)
    return m


COMMON = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2,
              max_new_tokens=16, max_seq_len=256, dtype="float32")
# Six requests of varied length (15 to 150 byte tokens) and budget: three
# queue behind the three slots.
REQUESTS = [("serving parity " * n, m) for n, m in ((1, 5), (4, 16), (10, 9), (2, 12), (7, 20),
                                                    (3, 7))]


def _drive(b, step, retire):
    """The same schedule for both batchers: admit, then one decode step per
    poll, retire, admit, until every slot is empty."""
    for prompt, budget in REQUESTS:
        b.submit(prompt, max_new_tokens=budget)
    b._admit_pending()
    for _ in range(200):
        if not any(s is not None for s in b._slots):
            break
        step()
        retire()
        b._admit_pending()
    assert not b.scheduler.pending()
    return {r["req_id"]: r for r in (b._done[i].result for i in sorted(b._done))}


def _run_jax(layout: str, page_size: int, target, draft):
    eng = JaxEngine(JaxEngineConfig(implementation="hf", kv_layout=layout,
                                    kv_page_size=page_size, kv_lazy_pages=False, **COMMON),
                    target_model=target, draft_model=draft)
    b = JaxBatcher(eng, n_slots=3)
    return _drive(b, lambda: b.step_chunk(1), b._retire_finished)


def _own_prompt_logprobs(eng, prompt: str, budget: int) -> np.ndarray:
    """Prompt logprobs from the port's B=1 forward over the unpadded prompt
    (no admission group, no padding), scored as the admission scores them."""
    ids = eng.encode(prompt, budget, eng.config.max_seq_len)
    n = len(ids)
    with torch.inference_mode():
        lg, _ = eng.target.forward(torch.tensor([ids], dtype=torch.int32),
                                   torch.arange(n, dtype=torch.int32)[None],
                                   eng.target.init_cache(1, n, "cpu"),
                                   torch.zeros(1, dtype=torch.int32))
    lg32 = lg[0, :-1].float()
    lp = lg32.gather(-1, torch.tensor(ids[1:])[:, None])[:, 0] - torch.logsumexp(lg32, -1)
    return lp.numpy()


@pytest.mark.parametrize("layout,page_size", [("contiguous", 64), ("paged", 16), ("paged", 64)])
def test_batcher_matches_jax(layout, page_size):
    """The port's ContinuousBatcher against the JAX one (kv_lazy_pages=False,
    eager page reservation as the port does), llama-tiny, f32, K=2, 3
    slots, 6 requests: per request, generated ids, proposed, accepted,
    generated tokens and finish reason are equal; token logprobs agree
    within 1e-4.

    Prompt logprobs come from the [G, P] admission prefill. They equal the
    port's own B=1 forward over the unpadded prompt within 1e-5 (the result
    rounds them to 6 decimals): a wrong row, splice or padding would move
    them by far more. Against JAX they agree within 1e-4 + 3e-5 |lp|. The
    gap is f32 rounding in the two libraries' forwards, not the port's
    batch: it is there at B=1 without padding, where each library is up to
    3e-4 from a float64 forward of the same weights, and JAX's own [G, P]
    prefill moves its logprobs by up to 1.4e-4 from its B=1 forward. No
    single op makes it: rounding any one op's output to f32 inside a
    float64 forward moves the logprobs by 3e-5 to 7e-5; at x10 weights the
    attention scores reach |s| ~ 1300. The gap grows with |lp|: at most
    6e-5 where |lp| < 6, and 2.2e-4 = 2.6e-5 |lp| at lp = -8.5 over the six
    prompts, none with |lp| < 3 (tests/torch_logprob_probe.py prints
    these)."""
    target, draft = _tiny(0), _tiny(0, mix_with=1)
    want = _run_jax(layout, page_size, target, draft)
    eng = Engine(EngineConfig(kv_layout=layout, kv_page_size=page_size, kv_lazy_pages=False,
                              **COMMON), device="cpu",
                 target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params))
    b = ContinuousBatcher(eng, n_slots=3)
    got = _drive(b, lambda: b.step_chunk(1), b._retire_finished)
    assert sorted(got) == sorted(want) == list(range(len(REQUESTS)))
    for rid, r in got.items():
        w = want[rid]
        for key in ("generated_ids", "proposed", "accepted", "generated_tokens", "finish_reason"):
            assert r[key] == w[key], (rid, key, r[key], w[key])
        np.testing.assert_allclose(r["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["prompt_logprobs"][1:], _own_prompt_logprobs(eng, *REQUESTS[rid]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["prompt_logprobs"][1:], w["prompt_logprobs"][1:],
                                   rtol=3e-5, atol=1e-4)
        assert r["prompt_logprobs"][0] is None and r["prompt_tokens_reused"] == 0
    assert sum(r["accepted"] for r in got.values()) > 0  # drafts are accepted: bonus paths run
    stats = b.stats.report(b.n_slots)
    assert stats["admitted"] == stats["retired"] == len(REQUESTS)
    assert stats["committed_tokens"] == sum(r["generated_tokens"] for r in got.values())
    assert stats["admit_waves"] >= 2  # the queued half was admitted as slots retired


@functools.lru_cache(maxsize=1)
def _tiny_params():
    return params_from_jax(_tiny(0).params), params_from_jax(_tiny(0, mix_with=1).params)


def _tiny_engine(**kw):
    cfg = dict(COMMON)
    cfg.update(kw)
    target, draft = _tiny_params()
    return Engine(EngineConfig(**cfg), device="cpu", target_params=target,
                  draft_params=draft if cfg["draft_model"] else None)


def test_paged_memory_aware_admission():
    """With a pool smaller than the queue's demand (kv_pages=5: 4 usable
    pages, 2 reserved per request), requests wait for pages, at most two
    run at once, all complete with the ids an unconstrained pool gives, and
    every page returns to the allocator. A request that cannot fit even in
    an empty pool raises instead of waiting forever."""
    prompts = [f"memory pressure {i} " * 3 for i in range(5)]

    def serve(**kw):
        b = ContinuousBatcher(_tiny_engine(kv_layout="paged", kv_page_size=64,
                                           kv_lazy_pages=False, **kw), n_slots=4)
        occupancy = []
        step_chunk = b.step_chunk

        def traced(*n):
            occupancy.append(sum(r is not None for r in b._slots))
            step_chunk(*n)

        b.step_chunk = traced
        for p in prompts:
            b.submit(p, max_new_tokens=8)
        return b, b.run(), max(occupancy)

    b, out, peak = serve(kv_pages=5)
    roomy, ref, roomy_peak = serve()
    assert len(out) == 5 and all(r["generated_tokens"] > 0 for r in out)
    assert peak == 2 and roomy_peak == 4
    assert b.allocator.free_pages == 4
    assert [r["generated_ids"] for r in out] == [r["generated_ids"] for r in ref]
    tight = ContinuousBatcher(_tiny_engine(kv_layout="paged", kv_page_size=64, kv_pages=2,
                                           kv_lazy_pages=False), n_slots=2)
    tight.submit("x" * 100, max_new_tokens=8)
    with pytest.raises(RuntimeError, match="more KV pages"):
        tight.run()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_empty_slot_does_not_change_results(layout):
    """A single request decodes exactly alike in a 1-slot and a 2-slot
    batcher: the empty slot (position -1, dead attention rows) writes
    nothing a live row reads."""
    def run(n_slots):
        b = ContinuousBatcher(_tiny_engine(draft_model=None, kv_layout=layout, max_new_tokens=8),
                              n_slots=n_slots)
        b.submit("empty slot regression")
        return b.run()[0]

    one, two = run(1), run(2)
    assert one["generated_ids"] == two["generated_ids"] and one["generated_tokens"] == 8
    # The CPU's matmul rounds a row differently at 1 and 2 rows: 1e-5.
    np.testing.assert_allclose(one["token_logprobs"], two["token_logprobs"], rtol=0, atol=1e-5)


def test_retired_slot_cannot_corrupt_reused_pages():
    """A retired slot's lane still rides every step and writes K+1 junk KV
    rows at its stale offset. Retirement zeroes the slot's table rows, so
    those writes land in the dummy page 0 and never in a freed page that a
    new request owns next."""
    b = ContinuousBatcher(_tiny_engine(max_draft=3, max_new_tokens=24, kv_layout="paged",
                                       kv_page_size=16, kv_pages=64), n_slots=3)
    b.submit("short one")
    b.submit("short two here")
    first = b.run()
    for cache in (b.state.target_cache, b.state.draft_cache):
        assert (cache.table[:2] == 0).all(), "retired table rows must be cleared"
    rid = b.submit("probe " * 10)
    b._admit_pending()
    slot = next(i for i, r in enumerate(b._slots) if r is not None)
    first_page = int(b.state.target_cache.table[slot, 0])
    assert first_page != 0
    before = b.state.target_cache.k[0, first_page].clone()
    b.step_chunk(2)
    b._retire_finished()
    after = b.state.target_cache.k[0, first_page]
    guard = min(16, len(b._slots[slot].ids))  # page rows holding prompt KV stay put
    assert torch.equal(before[:, :guard], after[:, :guard])
    res = {r["req_id"]: r for r in b.run()}
    assert res[rid]["generated_tokens"] > 0 and len(first) == 2
    # The probe decodes as it does alone in a fresh batcher.
    alone = ContinuousBatcher(_tiny_engine(max_draft=3, max_new_tokens=24, kv_layout="paged",
                                           kv_page_size=16, kv_pages=64), n_slots=3)
    alone.submit("probe " * 10)
    assert alone.run()[0]["generated_ids"] == res[rid]["generated_ids"]
