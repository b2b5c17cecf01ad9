"""Port parity: serving's admission and KV memory on the other serving
paths, against the JAX package on the CPU: lazy pages with preemption,
incremental admission and prefix caching with a draft model over int8
pools, under the tree, and with ngram drafting. The checks are those of
test_torch_lazy_pages.py, test_torch_admit_chunked.py and
test_torch_prefix_cache.py, whose helpers these tests call; the port runs
on its decode loop.
"""

import pytest

from test_torch_admit_chunked import LONG, SHORT, _incremental_against_one_shot
from test_torch_lazy_pages import check_preemption, jax_batcher, one_thread  # noqa: F401
from test_torch_lazy_pages import port_engine
from test_torch_prefix_cache import LONG as PREFIX_LONG
from test_torch_prefix_cache import _pair_run


@pytest.mark.parametrize("case", ["preempts int8 spec", "preempts tree"])
def test_preemption_resumes_by_recompute(case):
    """test_torch_lazy_pages.py's check_preemption with a K=2 draft model
    over int8 pools (the resumed request's draft cache and scales are
    recomputed too) and under the tree (a growth margin of 100 tokens)."""
    check_preemption(case, None)


PATHS = {
    "vanilla K=2 int8 KV paged": dict(draft_model="llama-tiny", max_draft=2,
                                      kv_quantization="int8", kv_layout="paged"),
    "tree contiguous": dict(draft_mode="tree", tree={"branching": [3, 2]}),
    "ngram paged": dict(draft_mode="ngram", max_draft=3, kv_layout="paged"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_incremental_on_every_serving_path(path):
    """Incremental admission against one-shot and JAX's
    (test_torch_admit_chunked.py's checks) on a draft model over int8 pools,
    the tree and ngram."""
    cfg = dict(dict(base_model="llama-tiny", draft_model=None, max_new_tokens=8,
                    max_seq_len=512, dtype="float32", kv_page_size=16, admit_chunk=64,
                    eos_token_id=-1), **PATHS[path])
    _incremental_against_one_shot(cfg, jax_batcher(cfg, 2), port_engine,
                                  [(SHORT, 8), (LONG, 8)], 2)


@pytest.mark.parametrize("kw", [dict(kv_quantization="int8"),
                                dict(draft_model=None, draft_mode="tree",
                                     tree={"branching": [3, 2]})], ids=["int8 KV", "tree"])
def test_prefix_caching_int8_kv_and_tree(kw):
    """A cached repeat over int8 pools (the reused pages' scales are
    shared with their rows: the port's logprobs equal its uncached run's
    bit for bit, and part from JAX's only where its uncached run does) and
    under the tree (its verify chunk writes past the prompt, never into a
    shared page)."""
    b, got = _pair_run([(PREFIX_LONG, 8)] * 2, 1, [[0], [1]], prefix_caching=True, **kw)
    assert got[1]["prompt_tokens_reused"] == 144
