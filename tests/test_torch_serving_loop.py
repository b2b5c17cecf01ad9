"""Port parity: JAX's pipelined serving loop, adaptive K in the batcher and
the scheduler's EMA (core/batching.py ``run``, ``poll_flags_async``,
``step_chunk(None)``, ``_next_chunk_len``, ``_calibrate_chunk_cost``,
``_prefetch_retire``, ``_retire_finished(flags)``, ``_admit_overlapped``,
``_admit_post_poll``, ``_plan_chunk_admissions``; core/scheduler.py
``record_step``) against the JAX package on the CPU.

The scheduler's K and EMA, ``_next_chunk_len`` on seeded slot states and
``_calibrate_chunk_cost`` on seeded samples are exact against JAX's. Both
batchers then run the same workloads through ``run()`` or JAX's server-loop
order with arrivals after every chunk (``pipelined``): contiguous on the
fake model, paged on llama-tiny (eager pages; lazy pages at half the pool
with a preemption), and under overlapped and fused admission (JAX's
``SPECDX_OVERLAP_ADMIT`` / ``SPECDX_FUSED_ADMIT``, the port's EnvFlags).
Results (ids, proposed, accepted, finish reason, slot), the report's counts,
the per-poll trace rows (but their wall-clock t), the slots' page ids after
every poll and the host controller's K after every poll are equal. No wall
clock decides a schedule: both batchers' chunk cost models are pinned to
the same constants and their refits turned off. Two faults of JAX's loop
are pinned beside the port's fixes: a preemption victim that finished
since the snapshot is requeued and generates past its budget, and run()
returns without the requests left at its step limit. The profiler's
parity is test_torch_profiler.py's.
"""

import types

import numpy as np
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.native import NativeScheduler
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.scheduler import Scheduler
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_admit_chunked import LONG
from test_torch_lazy_pages import (CASES, LAZY, jax_batcher, port_engine, reference_ids,
                                   snapshot)

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=2,
            max_new_tokens=8, max_seq_len=256)
COUNTS = ("chunks", "steps", "polls", "admitted", "admit_waves", "admit_fused", "retired",
          "committed_tokens", "page_grows", "preemptions")
RESULT_KEYS = ("generated_ids", "finish_reason", "slot", "generated_tokens")
SWITCHES = {"overlap": ("SPECDX_OVERLAP_ADMIT", EnvFlags(overlap_admit=True)),
            "fused": ("SPECDX_FUSED_ADMIT", EnvFlags(fused_admit=True))}


# ------------------------------------------------------------- scheduler
@pytest.mark.parametrize("params", [{}, dict(init_k=2, min_k=1, max_k=6, target_acceptance=0.3,
                                             window=8),
                                    dict(init_k=5, min_k=2, max_k=5, target_acceptance=0.9,
                                         window=64)])
def test_scheduler_adaptive_k_equals_native(params):
    """record_step's K, k and acceptance_ema after every call equal
    NativeScheduler(force_python=True)'s exactly, over 400 seeded (proposed,
    accepted) pairs (zeros, all accepted and none among them)."""
    rng = np.random.default_rng(7)
    ours, ref = Scheduler(**params), NativeScheduler(force_python=True, **params)
    for _ in range(400):
        prop = int(rng.integers(0, 12))
        acc = int(rng.integers(0, prop + 1)) if rng.random() < 0.8 else prop
        assert ours.record_step(prop, acc) == ref.record_step(prop, acc)
        assert (ours.k, ours.acceptance_ema) == (ref.k, ref.acceptance_ema)


# ---------------------------------------------------- the chunk cost model
def _slot_state(rng, n_slots, poll_every):
    """A duck-typed batcher for the unbound _next_chunk_len: seeded slots
    (empty, prefilling or decoding at random lengths and budgets), queue
    and cost constants."""
    slots, sched = [], np.zeros(n_slots, np.int64)
    for s in range(n_slots):
        if rng.random() < 0.2:
            slots.append(None)
            continue
        plen, budget = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        slots.append(types.SimpleNamespace(admit_ids=[0] * plen, remaining_new=budget,
                                           prefilling=bool(rng.random() < 0.1)))
        sched[s] = plen + int(rng.integers(0, budget + 3))
    pending = int(rng.integers(0, 3))
    return types.SimpleNamespace(
        poll_every=poll_every, n_slots=n_slots, _slots=slots, _sched_len=sched,
        scheduler=types.SimpleNamespace(pending=lambda: pending),
        chunk_boundary_ms=float(rng.uniform(0.1, 12.0)), chunk_step_ms=float(rng.uniform(1, 30)))


def test_next_chunk_len_equals_jax():
    """_next_chunk_len on 600 seeded slot states (2 to 16 slots, poll_every
    4 or 8) equals JAX's exactly, and cuts chunks short in some."""
    rng = np.random.default_rng(3)
    cut = 0
    for i in range(600):
        st = _slot_state(rng, int(rng.integers(2, 17)), (4, 8)[i % 2])
        got = ContinuousBatcher._next_chunk_len(st)
        assert got == JaxBatcher._next_chunk_len(st), i
        cut += got < st.poll_every
    assert cut > 50


def test_calibrate_chunk_cost_equals_jax():
    """_calibrate_chunk_cost over 200 seeded (n, wall ms) samples (a line
    with noise, then host-bound outliers) moves the cost constants exactly
    as JAX's after every sample, and does move them."""
    rng = np.random.default_rng(11)
    ours = types.SimpleNamespace(_cal_hist=[], chunk_step_ms=6.6, chunk_boundary_ms=8.0)
    ref = types.SimpleNamespace(_cal_hist=[], chunk_step_ms=6.6, chunk_boundary_ms=8.0)
    for i in range(200):
        n = int(rng.integers(1, 9))
        line = 2.5 + 11.0 * n + float(rng.normal(0, 0.5))
        wall = line if i < 150 else float(rng.uniform(0, 500))
        ContinuousBatcher._calibrate_chunk_cost(ours, n, wall)
        JaxBatcher._calibrate_chunk_cost(ref, n, wall)
        assert (ours.chunk_step_ms, ours.chunk_boundary_ms) == (ref.chunk_step_ms,
                                                                ref.chunk_boundary_ms), i
        if i == 149:  # the fit has converged to the line
            assert abs(ours.chunk_step_ms - 11.0) < 1.0 and abs(ours.chunk_boundary_ms - 2.5) < 2


def _pin(b):
    """JAX's cold-start cost constants on either batcher, refits off."""
    b.chunk_boundary_ms, b.chunk_step_ms = 8.0, 6.6
    b._calibrate_chunk_cost = lambda n, wall_ms: None
    return b


def test_exact_retirement_chunk_scheduling():
    """JAX's test_exact_retirement_chunk_scheduling on both batchers (the
    fake target without a draft, 2 slots, poll_every 8): the chunk is cut
    at the short request's finish while a third waits, full with the queue
    empty; the results equal JAX's and a fixed-chunk drive's."""
    cfg = dict(FAKE, draft_model=None, max_new_tokens=16)
    reqs = [("short one", 3), ("much longer request", 11), ("queued third", 5)]
    out = []
    for b in (_pin(ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2, poll_every=8)),
              _pin(JaxBatcher(JaxEngine(JaxEngineConfig(**cfg)), n_slots=2, poll_every=8))):
        for p, m in reqs:
            b.submit(p, max_new_tokens=m)
        b._admit_pending()
        assert b._next_chunk_len() == 3
        b.step_chunk()
        assert b._last_chunk_n == 3
        b._retire_finished()
        b._admit_pending()
        assert b._next_chunk_len() == b.poll_every
        out.append(b.run())
    assert [r["generated_tokens"] for r in out[0]] == [3, 11, 5]
    assert [r["generated_ids"] for r in out[0]] == [r["generated_ids"] for r in out[1]]
    b2 = ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2, poll_every=8)
    for p, m in reqs:
        b2.submit(p, max_new_tokens=m)
    b2._admit_pending()
    while any(s is not None for s in b2._slots) or b2.scheduler.pending():
        b2.step_chunk(8)
        b2._retire_finished()
        b2._admit_pending()
    assert [b2._done[i].result["generated_ids"] for i in sorted(b2._done)] == [
        r["generated_ids"] for r in out[0]]


def test_step_equals_jax():
    """step() (JAX's one-step call) on both batchers, each followed by a
    poll of the state now: the same lengths, active flags, step count, K and
    retirements while a lane is active. Past that (every lane finished) JAX's
    single-step program still adds 1 to the state's step counter, which its
    decode loop and the port's step do not (they add active.any()): the
    port's count stays, JAX's grows (pinned)."""
    both = (ContinuousBatcher(Engine(EngineConfig(**FAKE), device="cpu"), 2),
            JaxBatcher(JaxEngine(JaxEngineConfig(**FAKE)), n_slots=2))
    seen = []
    for b in both:
        b.submit("one step at a time", max_new_tokens=6)
        b.submit("and another", max_new_tokens=3)
        b._admit_pending()
        rows = []
        for _ in range(4):
            b.step()
            b._retire_finished()
            rows.append((np.asarray(b.state.lengths).tolist(), np.asarray(b.state.active).tolist(),
                         b.stats.steps, b._current_k(), b.stats.retired))
        seen.append(rows)
    (ours, ref) = seen
    assert ours[:2] == ref[:2] and not any(ours[1][1])
    assert [r[2] for r in ours[1:]] == [2, 2, 2] and [r[2] for r in ref[1:]] == [2, 3, 4]
    assert [r[:2] + r[3:] for r in ours] == [r[:2] + r[3:] for r in ref]


# ------------------------------------------------------------ the loop
def _watch(b):
    """Record after every poll: the slots' requests, page ids, reuse and
    incremental state with the pool's free count and the growth and
    preemption counts (test_torch_lazy_pages.snapshot), and the scheduler's
    K. Both batchers' polls are _retire_finished."""
    seen = []
    inner = b._retire_finished

    def poll(flags=None):
        inner(flags)
        seen.append((snapshot(b), b.scheduler.k))

    b._retire_finished = poll
    return seen


def pipelined(b, reqs, arrivals=2, limit=400):
    """JAX's server-loop order (server/serving.py:170-201) with staggered
    arrivals: `arrivals` requests submitted before each cycle (the rest of
    the queue at once when nothing decodes), then snapshot, step_chunk(),
    _admit_overlapped, _prefetch_retire, _retire_finished(flags),
    _admit_post_poll. Returns the results by req_id."""
    queue = list(reqs)
    for _ in range(limit):
        for _ in range(arrivals):
            if queue:
                b.submit(*queue.pop(0))
        if not any(s is not None for s in b._slots):
            if not queue and not b.scheduler.pending():
                break
            b._admit_pending()
        flags = b.poll_flags_async()
        b.step_chunk()
        b._admit_overlapped()
        fresh = b._prefetch_retire(flags)
        b._retire_finished(fresh if fresh is not None else flags)
        b._admit_post_poll()
    assert not queue and not b.scheduler.pending()
    assert not any(s is not None for s in b._slots)
    return {rid: r.result for rid, r in b._done.items()}


def _runner(kind):
    if kind == "run":
        def go(b, reqs):
            for p, m in reqs:
                b.submit(p, max_new_tokens=m)
            return {r["req_id"]: r for r in b.run()}
        return go
    return lambda b, reqs: pipelined(b, [(p, m) for p, m in reqs])


def serve_both(jb, b, reqs, kind):
    """The same workload through both batchers (pinned cost models, traces
    and per-poll watches on), then same_loop."""
    out = []
    for x in (jb, b):
        _pin(x)
        x.start_trace()
        seen = _watch(x)
        out.append((_runner(kind)(x, reqs), [{k: v for k, v in row.items() if k != "t"}
                                             for row in x.trace], seen))
    same_loop(jb, b, *out)


def same_loop(jb, b, want, got):
    """Results, report counts, trace rows and per-poll watches equal;
    proposed and accepted for requests never preempted (the port's result
    also counts the slots a preemption took)."""
    (wres, wtrace, wseen), (gres, gtrace, gseen) = want, got
    assert sorted(gres) == sorted(wres)
    for rid, r in gres.items():
        w = wres[rid]
        for key in RESULT_KEYS:
            assert r[key] == w[key], (rid, key, r[key], w[key])
        if b._done[rid].resume_ids is None:
            assert (r["proposed"], r["accepted"]) == (w["proposed"], w["accepted"]), rid
    rep, jrep = b.stats.report(b.n_slots), jb.stats.report(jb.n_slots)
    assert {k: rep[k] for k in COUNTS} == {k: jrep[k] for k in COUNTS}
    assert gtrace == wtrace
    assert gseen == wseen


FAKE_REQS = [(f"pipelined prompt {i} " * (1 + i % 3), 3 + (5 * i) % 11) for i in range(9)]
PAGED = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2, max_new_tokens=16,
             max_seq_len=256, dtype="float32", kv_layout="paged", kv_page_size=16,
             kv_lazy_pages=False)
PAGED_REQS = [("serving parity " * n, m) for n, m in ((1, 5), (4, 16), (10, 9), (2, 12),
                                                      (7, 14), (3, 7))]


@pytest.mark.parametrize("kind", ["run", "pipelined"])
def test_loop_matches_jax_contiguous(kind):
    """The fake target and draft (K=2), 3 slots, 9 requests of budgets 3 to
    13: run() and the server-loop order with two arrivals a cycle."""
    serve_both(JaxBatcher(JaxEngine(JaxEngineConfig(**FAKE)), n_slots=3),
               ContinuousBatcher(Engine(EngineConfig(**FAKE), device="cpu"), 3), FAKE_REQS, kind)


@pytest.mark.parametrize("kind", ["run", "pipelined"])
def test_loop_matches_jax_paged(kind):
    """llama-tiny target and draft (K=2, f32), pages of 16 reserved at
    admission, 3 slots, 6 requests."""
    jb = jax_batcher(dict(PAGED), 3)
    b = ContinuousBatcher(port_engine(dict(PAGED)), 3)
    serve_both(jb, b, PAGED_REQS, kind)
    assert b.stats.admit_waves >= 2


@pytest.mark.parametrize("kind", ["run", "pipelined"])
def test_loop_matches_jax_lazy_pages_preemption(kind):
    """Lazy pages at half the pool (test_torch_lazy_pages "preempts": 7
    usable pages for two requests of 48 tokens): the lagged polls grow
    pages, preempt the younger request and resume it, with JAX's page ids
    after every poll; every page returns."""
    cfg, reqs, n_slots = CASES["preempts"]
    jb, b = jax_batcher(cfg, n_slots), ContinuousBatcher(port_engine(cfg), n_slots)
    serve_both(jb, b, reqs, kind)
    assert b.stats.preemptions >= 1 and b.stats.page_grows > 0
    assert b.allocator.free_pages == cfg["kv_pages"] - 1


# The younger request finishes in the chunk run since the snapshot that the
# older one's growth preempts it from.
FINISHED_VICTIM = (dict(LAZY, kv_pages=7),
                   [("preempt victim check", 48), ("preempt survivor check", 22)])


def _serve_finished_victim(b):
    for p, m in FINISHED_VICTIM[1]:
        b.submit(p, max_new_tokens=m)
    return _pin(b).run()


def test_jax_requeues_a_finished_victim():
    """JAX's fault, pinned: its _apply_growth requeues a victim that
    finished in the chunk since the snapshot (its lane is inactive in the
    fresh read), with all its tokens; the resumed request's budget is
    floored at 1, so it generates a 23rd token past its 22 and ends
    "length"."""
    jb = jax_batcher(FINISHED_VICTIM[0], 2)
    res = _serve_finished_victim(jb)
    assert [r["generated_tokens"] for r in res] == [48, 23]
    assert res[1]["finish_reason"] == "length" and jb.stats.preemptions == 1


def test_finished_victim_retires_not_requeued():
    """The port's fix: that victim retires from the fresh read with its 22
    tokens (the uninterrupted generate's ids, JAX's up to its extra one),
    nothing is preempted and every page and committed token is counted;
    the older request's ids equal JAX's."""
    cfg, reqs = FINISHED_VICTIM
    b = ContinuousBatcher(port_engine(cfg), 2)
    res = _serve_finished_victim(b)
    want = _serve_finished_victim(jax_batcher(cfg, 2))
    assert [r["generated_tokens"] for r in res] == [48, 22]
    assert [r["generated_ids"] for r in res] == reference_ids(cfg, reqs)
    assert res[0]["generated_ids"] == want[0]["generated_ids"]
    assert res[1]["generated_ids"] == want[1]["generated_ids"][:22]
    assert res[1]["finish_reason"] == "length" and b.stats.preemptions == 0
    assert b.stats.committed_tokens == 70 and b.stats.retired == 2
    assert b.allocator.free_pages == cfg["kv_pages"] - 1


def test_run_drains_long_incremental_admissions():
    """run()'s step limit counts the steps in which a lane was active:
    eight prompts of four 64-token admission chunks each, budget 1, 2
    slots, all served. JAX's run() counts each admission chunk as a full
    chunk of steps, reaches its default limit and returns 5 of the 8 with
    no error (pinned). An explicit max_steps returns what finished by
    then; the default limit reached with requests left raises."""
    cfg = dict(FAKE, max_draft=3, max_new_tokens=1, max_seq_len=512, admit_chunk=64)
    prompts = [LONG + str(i) for i in range(8)]
    b = _pin(ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2))
    jb = _pin(JaxBatcher(JaxEngine(JaxEngineConfig(**cfg)), n_slots=2))
    for x in (b, jb):
        for p in prompts:
            x.submit(p, max_new_tokens=1)
    got, want = b.run(), jb.run()
    assert [r["generated_tokens"] for r in got] == [1] * 8 and len(want) == 5
    assert [r["generated_ids"] for r in got[:5]] == [r["generated_ids"] for r in want]
    part = _pin(ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2))
    for p in prompts:
        part.submit(p, max_new_tokens=1)
    assert len(part.run(max_steps=1)) < 8
    stuck = _pin(ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2))
    stuck.submit(prompts[0], max_new_tokens=1)
    stuck._max_req_new = -2  # a default limit of 0 steps
    with pytest.raises(RuntimeError, match=r"unfinished"):
        stuck.run()


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("kind", ["run", "pipelined"])
def test_loop_matches_jax_admission_switches(switch, kind, monkeypatch):
    """Overlapped and fused admission (off by default in both packages) on
    the fake model: the same results, counts (admit_fused among them),
    trace rows and polls as JAX's under its environment switch; fused
    admission does ride chunks."""
    env, flags = SWITCHES[switch]
    monkeypatch.setenv(env, "1")
    jb = JaxBatcher(JaxEngine(JaxEngineConfig(**FAKE)), n_slots=3)
    b = ContinuousBatcher(Engine(EngineConfig(**FAKE), device="cpu", flags=flags), 3)
    serve_both(jb, b, FAKE_REQS, kind)
    if switch == "fused":
        assert b.stats.admit_fused > 0


# ------------------------------------------------------------ adaptive K
ADAPTIVE = dict(FAKE, controller="adaptive", max_new_tokens=24)


@pytest.mark.parametrize("target,k_end", [(0.05, 4), (0.99, 1)])
def test_batcher_feeds_adaptive_k(target, k_end):
    """JAX's test_batcher_feeds_adaptive_k on both batchers (2 slots,
    poll_every 2, 4 requests of 24 tokens, the fake draft agreeing ~85%):
    K climbs to max_k 4 at target 0.05, falls to 1 at 0.99; the K after
    every poll, the results and the counts equal JAX's."""
    cfg = dict(ADAPTIVE, controller_params={"min_k": 1, "max_k": 4,
                                            "target_acceptance": target},
               max_draft=2 if target < 0.5 else 4)
    jb = JaxBatcher(JaxEngine(JaxEngineConfig(**cfg)), n_slots=2, poll_every=2)
    b = ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2, poll_every=2)
    reqs = [(f"adaptive serving prompt {i}", 24) for i in range(4)]
    serve_both(jb, b, reqs, "run")
    assert b.scheduler.k == jb.scheduler.k == k_end
    assert b._prev_prop > 0


def test_adaptive_k_loops_at_each_k():
    """The host controller's chunks run at the scheduler's K: a loop per K
    captured over the batcher's state (the engine's own loop at K =
    max_draft), equal ids to the fixed-K batcher's."""
    cfg = dict(ADAPTIVE, controller_params={"min_k": 1, "max_k": 4, "target_acceptance": 0.05})
    b = _pin(ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), 2, poll_every=2))
    fixed = _pin(ContinuousBatcher(Engine(EngineConfig(**dict(FAKE, max_new_tokens=24)),
                                          device="cpu"), 2, poll_every=2))
    reqs = [(f"adaptive serving prompt {i}", 24) for i in range(4)]
    got, want = _runner("run")(b, reqs), _runner("run")(fixed, reqs)
    assert [r["generated_ids"] for r in got.values()] == [r["generated_ids"]
                                                        for r in want.values()]
    assert {k for k, _ in b._k_loops} == {3, 4}


def test_adaptive_device_serving_inherits_ctrl_k():
    """adaptive-device in the batcher: every chunk runs the engine's max-K
    step, each slot's K adapting on the device. Served ids equal B=1
    generate's; the slots' ctrl_k and acc_ema after the run equal JAX's;
    and admission leaves a slot's ctrl_k and acc_ema as its last tenant
    left them (JAX's make_admit_many does not reset them), so a new tenant
    starts at the old one's K."""
    cfg = dict(FAKE, controller="adaptive-device", max_draft=2, max_new_tokens=32,
               controller_params={"min_k": 1, "max_k": 5, "target_acceptance": 0.7,
                                  "window": 4})
    eng = Engine(EngineConfig(**cfg), device="cpu")
    jb = JaxBatcher(JaxEngine(JaxEngineConfig(**cfg)), n_slots=1)
    b = ContinuousBatcher(eng, 1)
    reqs = [("device controller one", 32), ("device controller two", 20)]
    serve_both(jb, b, reqs[:1], "run")
    left = (b.state.ctrl_k.tolist(), b.state.acc_ema.tolist())
    assert left[0] == np.asarray(jb.state.ctrl_k).tolist()
    np.testing.assert_allclose(left[1], np.asarray(jb.state.acc_ema), rtol=0, atol=1e-6)
    assert left[0] != [eng.controller.k]  # K moved during the first request
    for x in (b, jb):
        x.submit(*reqs[1])
        x._admit_pending()
    assert (b.state.ctrl_k.tolist(), b.state.acc_ema.tolist()) == left
    assert np.asarray(jb.state.ctrl_k).tolist() == left[0]
    rest = (b.run(), jb.run())
    assert rest[0][-1]["generated_ids"] == rest[1][-1]["generated_ids"]
    assert b.state.ctrl_k.tolist() == np.asarray(jb.state.ctrl_k).tolist()
    for (p, m), r in zip(reqs, [*_last(b)], strict=True):
        ref = Engine(EngineConfig(**dict(cfg, max_new_tokens=m)), device="cpu").generate(p)
        assert r["generated_ids"] == ref["generated_ids"]


def _last(b):
    return [b._done[i].result for i in sorted(b._done)]
