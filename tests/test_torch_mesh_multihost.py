"""Port parity for MultiHostBatcher's prefix caching, cancel and expert axis
on several ranks (core/multihost_batching.py _share_pages, cancel and
_apply_cancels, the data rows' rank layout) against the JAX package on the
CPU.

One launch of 4 gloo ranks (tests/torch_parallel_ranks.py, one thread
each). At data 2 x model 2, JAX's multi-host worker's tiny target and
draft (tests/test_torch_multihost.py) serve six requests with prefix
caching (pages of 16 tokens), three of them sharing a 40-token prefix:
request 0 writes the prefix's pages on data row 0 and request 5, admitted
into a slot of data row 1 once request 3 retires, reuses them. Each
request's ids and prompt tokens reused equal JAX's ContinuousBatcher in one
process (whose pool is one array), on every rank, and its token log-probs
within 1e-4 + 3e-5 |lp| (the ids of the tiny model repeat a token and would
not see a reused page of zeros). A batcher driven by hand
cancels request 5 while it waits in the queue and request 1 after its
first chunk: every rank gives the same results, request 5 cancelled with no
tokens, request 1 cancelled with the first tokens of its uncancelled ids.
At data 2 x expert 2, mixtral-tiny's served ids equal JAX's batcher's.
"""

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.models.base import ModelConfig
from llm_inference_lab_tpu_torch.parallel.multihost import launch

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_expert import _mixtral
from test_torch_multihost import jax_tiny, tiny_kw

PREFIX = "a shared system prompt of forty tokens: "
# The scheduler's first wave (length buckets of 32, alternating on ties) puts
# requests 1 and 0 on data row 0 (slots 0, 1) and 2 and 3 on data row 1;
# request 5 waits, and takes slot 3 (data row 1) once request 3 retires.
REQUESTS = [(PREFIX + "alpha", 12), ("an unrelated request", 48), ("short", 4),
            (PREFIX + "beta", 8), ("another unrelated request", 12), (PREFIX + "gamma", 8)]
KW = dict(ranks.mh_config("paged"), kv_page_size=16, prefix_caching=True, eos_token_id=-1)
MOE_KW = dict(base_model="mixtral-tiny", draft_model=None, max_new_tokens=8, max_seq_len=128,
              dtype="float32", eos_token_id=-1)
MOE_REQS = [("expert row one", 8), ("expert row two", 6), ("a third expert request", 8),
            ("four", 5), ("and a fifth", 7)]


@pytest.fixture(scope="module")
def weights():
    return jax_tiny(1, 2), jax_tiny(2, 1)


@pytest.fixture(scope="module")
def fleet(weights):
    target, draft = weights
    configs = {"mh-1": ModelConfig(dtype=torch.float32, **tiny_kw(1, 2)),
               "mh-2": ModelConfig(dtype=torch.float32, **tiny_kw(2, 1))}
    items = [("mh_prefix_cancel", (configs, KW, params_from_jax(target.params),
                                   params_from_jax(draft.params), REQUESTS, REQUESTS,
                                   {"data": 2, "model": 2})),
             ("mh_expert", ({}, MOE_KW, params_from_jax(_mixtral().params), MOE_REQS,
                            {"data": 2, "expert": 2}))]
    return launch(ranks.jobs, 4, args=(items,), threads=1, timeout=600)


def _jax_served(eng, reqs) -> list:
    b = JaxBatcher(eng, n_slots=4)
    rids = [b.submit(p, max_new_tokens=m) for p, m in reqs]
    done = {r["req_id"]: r for r in b.run()}
    return [done[rid] for rid in rids]


@pytest.fixture(scope="module")
def jax_prefix(weights):
    kw = {k: v for k, v in KW.items() if k not in ("base_model", "draft_model")}
    eng = JaxEngine(JaxEngineConfig(implementation="hf", **kw), target_model=weights[0],
                    draft_model=weights[1])
    return _jax_served(eng, REQUESTS)


def test_prefix_caching_across_data_rows_equals_jax(fleet, jax_prefix):
    """Ids and prompt tokens reused equal JAX's on every rank, and the token
    log-probs within 1e-4 + 3e-5 |lp|; request 5 reuses, on data row 1, the
    pages request 0 wrote on data row 0."""
    for r in range(4):
        got = fleet[r][0]["prefix"]
        assert [x["generated_ids"] for x in got] == [w["generated_ids"] for w in jax_prefix], r
        assert [x["prompt_tokens_reused"] for x in got] == [
            w["prompt_tokens_reused"] for w in jax_prefix], r
        for x, w in zip(got, jax_prefix):  # the reused rows' keys and values: the writer's
            np.testing.assert_allclose(x["token_logprobs"], w["token_logprobs"], rtol=3e-5,
                                       atol=1e-4, err_msg=f"rank {r} request {x['req_id']}")
    got = fleet[0][0]["prefix"]
    assert got[0]["slot"] < 2 <= got[5]["slot"] and got[5]["prompt_tokens_reused"] == 32


def test_cancel_queued_and_in_flight_on_every_rank(fleet, jax_prefix):
    """cancel(5) while queued and cancel(1) after the first chunk return
    True and cancel of an unknown id False; every rank gives the
    coordinator's results: request 5 cancelled with no tokens, request 1
    cancelled with the first tokens of its ids, the others whole."""
    assert fleet[0][0]["said"] == [True, True, False]
    got = fleet[0][0]["cancel"]
    for r in range(1, 4):
        assert fleet[r][0]["cancel"] == got, ("rank", r)
        assert fleet[r][0]["said"] == []
    by_id = {x["req_id"]: x for x in got}
    assert sorted(by_id) == list(range(len(REQUESTS)))
    assert by_id[5]["finish_reason"] == "cancelled" and by_id[5]["generated_ids"] == []
    one, whole = by_id[1]["generated_ids"], jax_prefix[1]["generated_ids"]
    assert by_id[1]["finish_reason"] == "cancelled" and 0 < len(one) < len(whole)
    assert one == whole[:len(one)]
    for rid in (0, 2, 3, 4):
        assert by_id[rid]["generated_ids"] == jax_prefix[rid]["generated_ids"], rid


def test_multihost_under_the_expert_axis_equals_jax(fleet):
    """MultiHostBatcher at data 2 x expert 2 (a data row's ranks are its
    expert ranks): JAX's batcher's ids on every rank."""
    want = [w["generated_ids"] for w in _jax_served(
        JaxEngine(JaxEngineConfig(implementation="hf", **MOE_KW), target_model=_mixtral()),
        MOE_REQS)]
    for r in range(4):
        assert fleet[r][1] == want, ("rank", r)
