"""The batcher through the decode loop on the CPU (ContinuousBatcher bound
at construction) against its host step and the JAX batcher; the weights
and helpers come from test_torch_decode_loop.py.
"""

import copy

import numpy as np
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from test_torch_decode_loop import SYNC, _engine, _pair, one_thread  # noqa: F401

# ------------------------------------------------------------ the batcher
SERVE = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2, max_new_tokens=16,
             max_seq_len=256, dtype="float32")
# Unequal budgets: a short request ends early in a chunk while the others
# decode on, and its slot is refilled.
SERVE_REQUESTS = [("serving parity " * n, m) for n, m in ((1, 3), (4, 17), (10, 9), (2, 5))]


def _serve(b, chunk):
    for prompt, budget in SERVE_REQUESTS:
        b.submit(prompt, max_new_tokens=budget)
    b._admit_pending()
    for _ in range(200):
        if not any(s is not None for s in b._slots):
            break
        b.step_chunk(chunk)
        b._retire_finished()
        b._admit_pending()
    return [b._done[i].result for i in sorted(b._done)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_batcher_loop_equals_host_step_and_jax(chunk, layout):
    """ContinuousBatcher through its decode loop (bound at construction),
    2 slots, 4 requests with budgets 3, 17, 9 and 5, chunks of 1 and 3
    steps between polls: every result equals the port's batcher with the
    functional step (sync_steps) exactly, and ids, proposed and accepted
    equal the JAX batcher's driven through the same admit / step_chunk /
    retire calls (token logprobs within 1e-4)."""
    target, draft = _pair("llama-tiny")
    kw = dict(SERVE, kv_layout=layout, kv_page_size=16)
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", kv_lazy_pages=False, **kw),
                     target_model=target, draft_model=draft)
    want = _serve(JaxBatcher(jeng, n_slots=2), chunk)
    kw["kv_lazy_pages"] = False
    got = _serve(ContinuousBatcher(_engine(kw), n_slots=2), chunk)
    host = _serve(ContinuousBatcher(_engine(kw, SYNC), n_slots=2), chunk)
    assert len(got) == len(host) == len(want) == len(SERVE_REQUESTS)
    for g, h, w in zip(got, host, want):
        for key in ("generated_ids", "token_logprobs", "prompt_logprobs", "proposed", "accepted",
                    "finish_reason"):
            assert g[key] == h[key], key
        for key in ("generated_ids", "proposed", "accepted", "finish_reason"):
            assert g[key] == w[key], (key, g[key], w[key])
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
    assert [len(r["generated_ids"]) for r in got] == [m for _, m in SERVE_REQUESTS]


def test_batcher_refuses_a_replaced_state():
    """The batcher's loop is bound to the state it made: a step over a state
    whose tensors were replaced raises instead of replaying over others."""
    b = ContinuousBatcher(_engine(SERVE), n_slots=2)
    b.submit("hello", max_new_tokens=4)
    b._admit_pending()
    b.step_chunk(1)
    b._retire_finished()
    b.state = copy.deepcopy(b.state)
    with pytest.raises(ValueError, match="another state"):
        b.step_chunk(1)
