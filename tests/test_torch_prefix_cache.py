"""Port parity: prefix caching (models/paged.py PrefixPageCache and the
batcher's prefix-cached admission, core/batching.py make_admit_prefix)
against the JAX package on the CPU.

The allocator is held to JAX's on the same operation sequences: the same
page ids, hits, misses, free and reclaimable counts. The batcher cases are
tests/test_prefix_caching.py's, each run through the JAX batcher and the
port's driven by the same explicit admit / step_chunk / retire calls
(test_torch_lazy_pages.py ``drive``): ids, page ids, reuse lengths, stats
and finish reasons exact, token logprobs within 1e-4; and each equal to the
uncached run. Weights: test_torch_decode_loop.py's llama-tiny (f32,
projections x10) carried over with convert.params_from_jax.
"""

import numpy as np
import pytest

from llm_inference_lab_tpu.models.paged import PrefixPageCache as JaxPrefixPageCache
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.models.paged import PrefixPageCache
from test_torch_lazy_pages import (drive, jax_batcher, one_thread, port_engine,  # noqa: F401
                                   same_gap, same_results)


# ---------------------------------------------------------------- allocator
def _state(c):
    return (list(c._free), dict(c._by_hash), {p: list(m) for p, m in c._meta.items()}, c._clock,
            c.hits, c.misses, c.free_pages, c.reclaimable_pages)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_on_random_operations(seed):
    """400 random alloc / register / match / free calls over prompts that
    share prefixes, with a pool small enough that alloc evicts: every call
    returns what JAX's returns and leaves the same free list, hash map,
    refcounts, LRU clock, hits and misses."""
    rng = np.random.default_rng(seed)
    ours, ref = PrefixPageCache(12, 4), JaxPrefixPageCache(12, 4)
    stems = [list(rng.integers(0, 50, 16)) for _ in range(3)]
    held = []  # (ids, pages) of the live requests
    for _ in range(400):
        op = rng.random()
        if op < 0.45:
            ids = [int(t) for t in stems[rng.integers(0, 3)][: rng.integers(2, 17)]]
            ids += [int(t) for t in rng.integers(0, 50, rng.integers(0, 6))]
            got, want = ours.match(ids, len(ids) - 2), ref.match(ids, len(ids) - 2)
            assert got == want
            shared, reuse = got
            need = -(-(len(ids) + 2) // 4) - len(shared)
            pages, pages_ref = ours.alloc(need), ref.alloc(need)
            assert pages == pages_ref
            if pages is None:
                ours.free(shared)
                ref.free(shared)
            else:
                ours.register(ids, shared + pages, reuse)
                ref.register(ids, shared + pages, reuse)
                held.append(shared + pages)
        elif held:
            pages = held.pop(int(rng.integers(0, len(held))))
            ours.free(pages)
            ref.free(pages)
        assert _state(ours) == _state(ref)
    assert ours.hits > 0 and ours.misses > 0


def test_chain_hash_full_chunks_only():
    c = PrefixPageCache(n_pages=16, page_size=4)
    ids = list(range(10))  # 2 full chunks + a partial one
    assert c.chunk_hashes(ids) == JaxPrefixPageCache(16, 4).chunk_hashes(ids)
    assert len(c.chunk_hashes(ids)) == 2
    other = [99, 98, 97, 96] + ids[4:]
    assert c.chunk_hashes(ids)[1] != c.chunk_hashes(other)[1]


def test_match_register_refcount_cycle():
    for c in (PrefixPageCache(16, 4), JaxPrefixPageCache(16, 4)):
        ids = list(range(12))
        pages = c.alloc(4)
        c.register(ids, pages, reuse_len=0)
        shared, reuse = c.match(ids, len(ids) - 2)
        assert reuse == 8 and shared == pages[:2]  # cap 10 tokens -> 2 chunks
        c.free(shared)
        c.free(pages)
        assert c.reclaimable_pages == 3
        assert c.match(ids, len(ids) - 2)[1] == 8  # still cached after both freed


def test_lru_eviction_under_pressure():
    out = []
    for c in (PrefixPageCache(5, 4), JaxPrefixPageCache(5, 4)):  # page 0 reserved: 4 usable
        a = c.alloc(2)
        c.register(list(range(8)), a, 0)
        c.free(a)
        b = c.alloc(2)
        c.register(list(range(100, 108)), b, 0)
        c.free(b)
        fresh = c.alloc(2)  # the pool is all cached pages: evicts the LRU pair
        assert fresh is not None
        assert c.match(list(range(8)), 8)[1] == 0
        out.append((a, b, fresh, c.match(list(range(100, 108)), 8)))
    assert out[0] == out[1]


def test_match_respects_cap():
    for c in (PrefixPageCache(16, 4), JaxPrefixPageCache(16, 4)):
        ids = list(range(8))
        c.register(ids, c.alloc(2), 0)
        shared, reuse = c.match(ids, len(ids) - 2)  # cap 6 -> 1 full chunk
        assert reuse == 4 and len(shared) == 1


# ------------------------------------------------------------------ batcher
# 159 byte tokens: nine full 16-token pages and a partial one.
LONG = "the quick brown fox jumps over the lazy dog and then " * 3
BASE = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2, max_new_tokens=8,
            max_seq_len=256, dtype="float32", kv_layout="paged", kv_page_size=16,
            eos_token_id=-1)


def _serve(b, reqs, waves):
    results, trace = {}, []
    for wave in waves:
        got, t = drive(b, [reqs[i] for i in wave])
        results.update(got)
        trace += t
    return results, trace


def _pair_run(reqs, n_slots, waves, **kw):
    """The JAX batcher and the port's (loop path) with prefix caching, and
    the port's without, each served `waves` (lists of request indices,
    drained in turn, as the JAX tests call run() between submits)."""
    cfg = dict(BASE, **kw)
    jb, b = jax_batcher(cfg, n_slots), ContinuousBatcher(port_engine(cfg), n_slots)
    (want, jtrace), (got, trace) = _serve(jb, reqs, waves), _serve(b, reqs, waves)
    uncached, _ = _serve(ContinuousBatcher(port_engine(dict(cfg, prefix_caching=False)),
                                           n_slots), reqs, waves)
    int8 = cfg.get("kv_quantization") == "int8"
    same_results(got, want, trace, jtrace, jb, b, logprobs=not int8)
    for rid, r in got.items():
        assert r["generated_ids"] == uncached[rid]["generated_ids"], rid
        np.testing.assert_allclose(r["token_logprobs"], uncached[rid]["token_logprobs"],
                                   rtol=0, atol=0 if int8 else 1e-4)
    if int8:
        jax_uncached, _ = _serve(jax_batcher(dict(cfg, prefix_caching=False), n_slots), reqs,
                                 waves)
        same_gap(got, want, uncached, jax_uncached)
    assert b.allocator.hits == jb.allocator.hits and b.allocator.misses == jb.allocator.misses
    return b, got


def test_prefix_cached_repeat_matches_uncached():
    """The same prompt twice through one slot: the second admission reuses
    the prefix pages (capped at 157 tokens: 144 reused) and gives the
    uncached ids; its prompt logprobs are None up to the reused length."""
    b, got = _pair_run([(LONG, 8)] * 2, 1, [[0], [1]], prefix_caching=True)
    assert got[0]["prompt_tokens_reused"] == 0 and got[1]["prompt_tokens_reused"] == 144
    assert got[0]["generated_ids"] == got[1]["generated_ids"] and b.allocator.hits > 0
    lp = got[1]["prompt_logprobs"]
    assert all(x is None for x in lp[:145]) and all(x is not None for x in lp[145:])


def test_shared_prefix_different_suffixes():
    b, got = _pair_run([(LONG + "ending one", 8), (LONG + "a different ending entirely", 8)],
                       1, [[0], [1]], prefix_caching=True)
    assert got[1]["prompt_tokens_reused"] > 0


def test_concurrent_shared_pages_survive_retirement():
    """Two requests in flight share the cached prefix; the one with the
    smaller budget retires first and the other's shared pages stay valid
    (refcounted): its ids are the uncached run's."""
    b, got = _pair_run([(LONG, 8), (LONG, 4), (LONG, 8)], 2, [[0], [1, 2]],
                       prefix_caching=True, draft_model=None)
    assert got[1]["prompt_tokens_reused"] > 0 and got[2]["prompt_tokens_reused"] > 0
    assert got[1]["generated_ids"] == got[2]["generated_ids"][:4]
    assert b.allocator.free_pages + b.allocator.reclaimable_pages == b.allocator.n_pages - 1


def test_prefix_caching_with_ngram_drafting():
    b, got = _pair_run([(LONG, 8)] * 2, 1, [[0], [1]], prefix_caching=True, draft_model=None,
                       draft_mode="ngram")
    assert got[1]["prompt_tokens_reused"] > 0 and b.state.draft_cache is None


def test_prefix_caching_with_eagle_hidden_carry():
    """EAGLE drafts from the hidden row at prompt length - 2, which the
    suffix recomputes (the match cap): the reused run's ids, proposed and
    accepted equal JAX's and the uncached run's ids."""
    b, got = _pair_run([(LONG, 8)] * 2, 1, [[0], [1]], prefix_caching=True, draft_model=None,
                       draft_mode="eagle")
    assert got[1]["prompt_tokens_reused"] > 0


def test_prefix_caching_needs_pages():
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(port_engine(dict(BASE, kv_layout="contiguous", prefix_caching=True)), 1)
