"""Port parity: the paged KV cache, paged decode attention (paged_flash),
prefill attention (flash_prefill), the attention routing, and
Engine.generate_batch with kv_layout="paged".

The same numpy inputs (fixed seeds) go through the JAX package (its Pallas
kernels in interpret mode, and its XLA references) and through
llm_inference_lab_tpu_torch on the CPU, where each op runs its plain
PyTorch version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import paged as jpaged
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops.paged_attention import paged_attend_xla
from llm_inference_lab_tpu.ops.pallas.flash_prefill import flash_prefill_attention
from llm_inference_lab_tpu.ops.pallas.paged_flash import paged_flash_attention
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models.base import ModelConfig
from llm_inference_lab_tpu_torch.models.paged import (
    PageAllocator,
    PagedKVCache,
    gather_pages,
    page_slots,
    write_paged_layer,
)
from llm_inference_lab_tpu_torch.ops import attention
from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_plain
from test_torch_decode_loop import one_thread  # noqa: F401


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_paged_write_and_gather_match_jax_exactly():
    """Two writes per layer (a 5-row prefill, then a 2-row decode chunk that
    crosses a page boundary) through shuffled page tables: the pools and the
    gathered contiguous views equal JAX update_paged_layer + gather_pages
    bit for bit."""
    rng = np.random.default_rng(0)
    L, N, KVH, P, D, B, M = 2, 9, 2, 8, 8, 2, 3
    cfg = ModelConfig(n_layers=L, n_heads=4, n_kv_heads=KVH, d_model=4 * D, dtype=torch.float32)
    table = (rng.permutation(N - 1)[: B * M].reshape(B, M) + 1).astype(np.int32)
    cache = PagedKVCache.create(cfg, B, M * P, "cpu", n_pages=N, page_size=P,
                                table=torch.from_numpy(table))
    assert cache.k.shape == (L, N, KVH, P, D) and cache.max_seq_len == M * P
    jk = [jnp.zeros((N, KVH, P, D), jnp.float32) for _ in range(L)]
    jv = [jnp.zeros((N, KVH, P, D), jnp.float32) for _ in range(L)]
    ones = jnp.ones((N, KVH, P), jnp.float32)
    for S, start in ((5, np.array([0, 3])), (2, np.array([7, 15]))):
        start = start.astype(np.int32)
        slots = page_slots(cache.table, torch.from_numpy(start), S, P)
        for layer in range(L):
            k_new = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
            v_new = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
            write_paged_layer(cache, layer, *_t(k_new, v_new), slots)
            jk[layer], jv[layer], _, _ = jpaged.update_paged_layer(
                jk[layer], jv[layer], ones, ones, jnp.asarray(k_new), jnp.asarray(v_new),
                jnp.asarray(start), jnp.asarray(table))
    for layer in range(L):
        np.testing.assert_array_equal(cache.k[layer].numpy(), np.asarray(jk[layer]))
        np.testing.assert_array_equal(cache.v[layer].numpy(), np.asarray(jv[layer]))
        got = gather_pages(cache.k[layer], cache.table)
        assert got.shape == (B, KVH, M * P, D)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jpaged.gather_pages(jk[layer], jnp.asarray(table))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_matches_jax(seed):
    """The same random alloc/free sequence gives the same pages, the same
    refusals and the same free counts as the JAX allocator."""
    rng = np.random.default_rng(seed)
    ours, ref = PageAllocator(12, 16), jpaged.PageAllocator(12, 16)
    held = []
    for _ in range(60):
        if held and rng.random() < 0.4:
            pages = held.pop(int(rng.integers(len(held))))
            ours.free(pages)
            ref.free(pages)
        else:
            n = int(rng.integers(0, 5))
            got, want = ours.alloc(n), ref.alloc(n)
            assert got == want
            if got is not None:
                assert 0 not in got
                held.append(got)
        assert ours.free_pages == ref.free_pages
        tokens = int(rng.integers(0, 100))
        assert ours.pages_needed(tokens) == ref.pages_needed(tokens)


def _paged_inputs(S, P, seed, B=2, KVH=2, group=2, D=128, span=96):
    """Pools of N pages, a shuffled table of M = span / P pages per sequence
    (page 0 never used), and queries at different depths per sequence."""
    rng = np.random.default_rng(seed)
    M = span // P
    N = B * M + 3
    H = KVH * group
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k_pool = rng.normal(size=(N, KVH, P, D)).astype(np.float32)
    v_pool = rng.normal(size=(N, KVH, P, D)).astype(np.float32)
    table = (rng.permutation(N - 1)[: B * M].reshape(B, M) + 1).astype(np.int32)
    pos = (np.array([[40], [span - S - 3]]) + np.arange(S)[None]).astype(np.int32)
    return q, k_pool, v_pool, pos, table


@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 2, 5])
def test_paged_flash_plain_matches_pallas_on_live_rows(S, P):
    """paged_flash_plain against paged_flash_attention(interpret=True):
    D=128, GQA group 2, shuffled tables, page sizes 16, 32 and 64. f32;
    tolerance 2e-5 absolute (outputs are O(1) averages of N(0,1) values,
    the softmax summed in another order)."""
    q, kp, vp, pos, table = _paged_inputs(S, P, seed=S * 100 + P)
    ref = paged_flash_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(pos), table=jnp.asarray(table), interpret=True)
    got = paged_flash(*_t(q, kp, vp, pos, table))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got.numpy(), paged_flash_plain(*_t(q, kp, vp, pos, table)).numpy())


@pytest.mark.parametrize("S", [1, 2, 5])
def test_paged_flash_plain_matches_xla_with_dead_row(S):
    """Against paged_attend_xla everywhere, including a dead row (position
    -1, an empty slot), which must be exactly zero."""
    q, kp, vp, pos, table = _paged_inputs(S, 32, seed=7 + S)
    pos[0, 0] = -1
    ref = np.asarray(paged_attend_xla(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(pos), table=jnp.asarray(table)))
    got = paged_flash_plain(*_t(q, kp, vp, pos, table)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    assert np.all(got[0, 0] == 0.0)


@pytest.mark.parametrize("group", [1, 2])
def test_flash_prefill_plain_matches_pallas(group):
    """flash_prefill (plain on the CPU) against flash_prefill_attention
    (interpret=True, block_s=block_t=128): B=2, S=256, T=512, D=128; row 0
    prefills from position 0, row 1 is a chunk resuming at base 128. f32;
    tolerance 2e-5 absolute."""
    rng = np.random.default_rng(5)
    B, KVH, D, S, T = 2, 2, 128, 256, 512
    q = rng.normal(size=(B, S, KVH * group, D)).astype(np.float32)
    k = rng.normal(size=(B, KVH, T, D)).astype(np.float32)
    v = rng.normal(size=(B, KVH, T, D)).astype(np.float32)
    pos = np.stack([np.arange(S), 128 + np.arange(S)]).astype(np.int32)
    ref = flash_prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), interpret=True, block_s=128, block_t=128)
    got = flash_prefill(*_t(q, k, v, pos))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_attention_routes_by_query_length(monkeypatch):
    """attend sends S > 32 to flash_prefill and S <= 32 to flash_decode, as
    the JAX dispatcher does; paged_attend sends S <= 32 to paged_flash and a
    longer S to flash_prefill over the gathered pages."""
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append((name, a[0].shape[1]))
            return fn(*a)
        monkeypatch.setattr(attention, name, wrapped)

    for name in ("flash_decode", "flash_prefill", "paged_flash"):
        spy(name, getattr(attention, name))
    rng = np.random.default_rng(6)
    B, H, KVH, D, T, P = 1, 4, 2, 64, 128, 32
    k = torch.from_numpy(rng.normal(size=(B, KVH, T, D)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(T // P + 1, KVH, P, D)).astype(np.float32))
    table = torch.arange(1, T // P + 1, dtype=torch.int32)[None]
    for S in (1, 32, 33, 96):
        q = torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
        pos = torch.arange(S, dtype=torch.int32)[None]
        out = attention.attend(q, k, k, pos)
        paged = attention.paged_attend(q, pool, pool, pos, table)
        # The paged path over the gathered pages computes the same function.
        contiguous = attention.attend(q, gather_pages(pool, table), gather_pages(pool, table), pos)
        np.testing.assert_array_equal(paged.numpy(), contiguous.numpy())
        assert out.shape == q.shape
    decode_calls = [c for c in calls if c[1] <= 32]
    assert {n for n, _ in decode_calls} == {"flash_decode", "paged_flash"}
    assert {n for n, s in calls if s > 32} == {"flash_prefill"}
    assert calls.count(("flash_prefill", 33)) == 3 and calls.count(("paged_flash", 32)) == 1


def test_config_validates_kv_layout():
    EngineConfig(kv_layout="paged", kv_page_size=16).validate()
    with pytest.raises(ValueError):
        EngineConfig(kv_layout="paged", kv_page_size=48).validate()
    with pytest.raises(ValueError):
        EngineConfig(kv_layout="ring").validate()


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


def test_paged_generate_batch_matches_jax_and_contiguous():
    """Engine.generate_batch with kv_layout="paged" (page size 64, two
    prompts, K=3, llama-tiny, f32): ids equal the JAX engine in paged mode
    and the port's own contiguous run; token logprobs agree within 1e-4."""
    target, draft = _tiny(0), _tiny(0, mix_with=1)
    common = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=3,
                  max_new_tokens=16, max_seq_len=256, dtype="float32")
    prompts = ["paged equivalence check", "second prompt with more words here"]
    jr = JaxEngine(JaxEngineConfig(implementation="hf", kv_layout="paged", kv_page_size=64,
                                   **common),
                   target_model=target, draft_model=draft).generate_batch(prompts)
    tp, dp = params_from_jax(target.params), params_from_jax(draft.params)

    def port(**kw):
        return Engine(EngineConfig(**common, **kw), device="cpu", target_params=tp,
                      draft_params=dp).generate_batch(prompts)

    paged, cont = port(kv_layout="paged", kv_page_size=64), port()
    for j, p, c in zip(jr, paged, cont):
        assert p["generated_ids"] == j["generated_ids"] == c["generated_ids"]
        assert len(set(p["generated_ids"])) > 3
        assert (p["proposed"], p["accepted"]) == (j["proposed"], j["accepted"])
        np.testing.assert_allclose(p["token_logprobs"], j["token_logprobs"], rtol=0, atol=1e-4)
