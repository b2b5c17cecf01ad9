"""Tree speculation (core/treespec.py) and the tree branch of attention
against the JAX package on the CPU.

The topology and the ancestry mask equal JAX's TreeConfig.build. The plain
versions of kernels D and F's tree variant give attend_xla's and
paged_attend_xla's tree branch (f32 queries over f32, bf16 and int8 caches,
1e-5), a node sees only its ancestors (JAX's branch-isolation case, a node
whose depth is below its chunk index), and the kernels' split arithmetic
written plainly agrees (F's with D's bits). Tree generate on the fake model
and on llama-tiny f32 (weights and heads carried over by
convert.params_from_jax, projections x10), contiguous and paged, gives
JAX's ids, proposed, accepted, steps and logprobs; a step at a time, the
committed cache rows after compaction equal JAX's; the batcher equals JAX's
and the port's own generate. A grammar (constrain or tools) in tree mode
raises JAX's error. The file runs on one intra-op thread (the one_thread
fixture).
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
from llm_inference_lab_tpu.core.specstep import make_prefill as jax_prefill
from llm_inference_lab_tpu.core.state import init_state as jax_init_state
from llm_inference_lab_tpu.core.treespec import TreeConfig as JaxTreeConfig
from llm_inference_lab_tpu.core.treespec import make_tree_spec_step as jax_tree_step
from llm_inference_lab_tpu.models import paged as jpaged
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu.ops.paged_attention import paged_attend_xla
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.specstep import make_prefill
from llm_inference_lab_tpu_torch.core.state import init_state
from llm_inference_lab_tpu_torch.core.treespec import TreeConfig, make_tree_spec_step
from llm_inference_lab_tpu_torch.models.base import quantize_rows
from llm_inference_lab_tpu_torch.models.paged import gather_pages
from llm_inference_lab_tpu_torch.ops.attention import attend, paged_attend
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    flash_decode_split_plain,
    flash_decode_tree,
    tree_bits,
)
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_split_plain
from test_torch_decode_loop import one_thread  # noqa: F401

BRANCHINGS = [[2], [2, 2], [3, 2], [2, 2, 2]]
KEYS = ("generated_ids", "proposed", "accepted", "bonus_tokens", "steps")


@pytest.mark.parametrize("branching", BRANCHINGS)
def test_topology_equals_jax(branching):
    """Parents, depths, ranks and the ancestry mask equal JAX's exactly; the
    kernels' ancestry words hold the mask's rows."""
    ours, theirs = TreeConfig(tuple(branching)), JaxTreeConfig(tuple(branching))
    assert (ours.depth, ours.num_nodes) == (theirs.depth, theirs.num_nodes)
    for a, b in zip(ours.build(), theirs.build(), strict=True):
        np.testing.assert_array_equal(a, b)
    anc = torch.from_numpy(ours.build()[3])
    bits = tree_bits(anc)
    for s in range(anc.shape[0]):
        assert [(int(bits[s]) >> j) & 1 for j in range(anc.shape[0])] == anc[s].int().tolist()
    if branching == [3, 2]:
        parents, depths, _, mask = ours.build()
        assert ours.num_nodes == 9 and parents.tolist()[:4] == [-1, 0, 0, 0]
        assert depths.tolist() == [0, 1, 1, 1, 2, 2, 2, 2, 2, 2]
        assert set(np.nonzero(mask[4])[0].tolist()) == {0, 1, 4} and not mask[4, 2]


def _tree_inputs(cache, seed, branching=(3, 2), B=2, H=4, KVH=2, T=64, D=64):
    """q [B, S, H, D] f32, k and v [B, KVH, T, D] (f32, bf16, or int8 with
    per-row scales), the ancestry mask and chunk starts (one near the end
    of the cache, one at slot -1: an empty batcher slot's)."""
    rng = np.random.default_rng(seed)
    anc = TreeConfig(tuple(branching)).build()[3]
    S = anc.shape[0]
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32)
    start = np.array([T - S - 3, -1][:B], np.int32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    ks = vs = None
    if cache == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    elif cache == "int8":
        (tk, ks), (tv, vs) = quantize_rows(tk), quantize_rows(tv)
    return (torch.from_numpy(q), tk, tv, ks, vs, torch.from_numpy(anc),
            torch.from_numpy(start))


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_plain_tree_attention_equals_attend_xla(cache):
    """attend(tree_mask, chunk_start) on the CPU (D's tree variant's plain
    version) against attend_xla's tree branch: 1e-5 absolute (f32 sums in
    another order); the positions are not read; a softcap and a score scale
    apply as in the chain branch. With F's plain version through a shuffled
    page table against paged_attend_xla, the same bound. A bf16 cache:
    JAX's CPU backend has no bf16 x bf16 -> f32 product, so attend_xla gets
    f32 copies of the same bf16 values; the port rounds p to bf16 before
    P.V (as attend_xla does for a bf16 cache), so the bound is 2^-8 of the
    largest |v| there."""
    q, k, v, ks, vs, anc, start = _tree_inputs(cache, seed=1)
    atol = 2.0 ** -8 * float(v.float().abs().max()) if cache == "bf16" else 1e-5

    def _jnp(t):
        return None if t is None else jnp.asarray(t.float().numpy() if t.is_floating_point()
                                                  else t.numpy())

    B, S = q.shape[:2]
    pos = torch.from_numpy(np.random.default_rng(2).integers(0, 60, (B, S)).astype(np.int32))
    for opts in ({}, {"softcap": 5.0, "scale": 0.1}):
        got = attend(q, k, v, pos, ks, vs, tree_mask=anc, chunk_start=start, **opts)
        want = attend_xla(_jnp(q), _jnp(k), _jnp(v), _jnp(pos), _jnp(ks), _jnp(vs),
                          tree_mask=_jnp(anc), chunk_start=_jnp(start), **opts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    # Paged: the same keys in pages of 16 through a shuffled table.
    P, T = 16, k.shape[2]
    M = T // P
    perm = np.random.default_rng(3).permutation(B * M) + 1
    table = torch.from_numpy(perm.reshape(B, M).astype(np.int32))
    N = B * M + 1

    def pool(x):
        out = x.new_zeros((N, x.shape[1], P, *x.shape[3:]))
        pages = x.reshape(B, x.shape[1], M, P, *x.shape[3:]).transpose(1, 2)
        out[table.long()] = pages
        return out

    kp, vp = pool(k), pool(v)
    ksp, vsp = (pool(ks), pool(vs)) if ks is not None else (None, None)
    got = paged_attend(q, kp, vp, pos, table, ksp, vsp, tree_mask=anc, chunk_start=start)
    want = paged_attend_xla(_jnp(q), _jnp(kp), _jnp(vp), _jnp(pos), _jnp(ksp), _jnp(vsp),
                            _jnp(table), tree_mask=_jnp(anc), chunk_start=_jnp(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_tree_mask_isolates_branches():
    """JAX's test_tree_mask_attention_isolates_branches through the port:
    equal scores, so each row is the mean of the value rows it sees. Node 1
    (chunk index 1, depth 1) sees the prefix and {4, 5}; node 2 (chunk
    index 2, but depth 1) sees the prefix and {4, 6}, not its sibling's
    slot 5 and not itself by position."""
    B, H, D, T = 1, 1, 64, 16
    anc = torch.from_numpy(TreeConfig((2,)).build()[3])
    q = torch.zeros((B, 3, H, D))
    k = torch.zeros((B, H, T, D))
    v = torch.arange(T, dtype=torch.float32)[None, None, :, None].expand(B, H, T, D).contiguous()
    pos = torch.tensor([[4, 5, 5]], dtype=torch.int32)
    out = attend(q, k, v, pos, tree_mask=anc, chunk_start=torch.tensor([4], dtype=torch.int32))
    assert out[0, 0, 0, 0] == pytest.approx(np.mean([0, 1, 2, 3, 4]), rel=1e-6)
    assert out[0, 1, 0, 0] == pytest.approx(np.mean([0, 1, 2, 3, 4, 5]), rel=1e-6)
    assert out[0, 2, 0, 0] == pytest.approx(np.mean([0, 1, 2, 3, 4, 6]), rel=1e-6)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_kernel_split_arithmetic_with_the_tree(cache):
    """The tree variant's split-and-combine (flash_decode_split_plain with
    tree_mask: splits of 16 keys at their slots, the block's range ending at
    the chunk's last slot) within 1e-5 of the one-pass plain version; F's
    (paged_flash_split_plain through a table) D's bits on the same keys,
    even with NaN in every pool row past the chunk and in unused pages."""
    q, k, v, ks, vs, anc, start = _tree_inputs(cache, seed=4, T=96)
    B, S = q.shape[:2]
    pos = torch.zeros((B, S), dtype=torch.int32)
    opts = dict(tree_mask=anc, chunk_start=start)
    one = flash_decode_tree(q, k, v, anc, start, ks, vs)
    split = flash_decode_split_plain(q, k, v, pos, ks, vs, split=16, **opts)
    torch.testing.assert_close(split, one, rtol=0, atol=1e-5)
    P, T = 16, k.shape[2]
    M = T // P
    table = torch.from_numpy((np.arange(B * M)[::-1].reshape(B, M) + 1).astype(np.int32))
    N = B * M + 1

    def pool(x, fill):
        out = torch.full((N, x.shape[1], P, *x.shape[3:]), fill, dtype=x.dtype)
        out[table.long()] = x.reshape(B, x.shape[1], M, P, *x.shape[3:]).transpose(1, 2)
        for b in range(B):  # past the chunk: never read
            last = int(start[b]) + S
            for j in range(max(last, 0), T):
                out[int(table[b, j // P]), :, j % P] = fill
        return out

    bad = 0 if cache == "int8" else float("nan")  # int8 rows: NaN in their scales
    kp, vp = pool(k, bad), pool(v, bad)
    ksp, vsp = ((pool(ks, float("nan")), pool(vs, float("nan"))) if ks is not None
                else (None, None))
    paged = paged_flash_split_plain(q, kp, vp, pos, table, ksp, vsp, split=16, **opts)
    assert torch.equal(paged, split)


FAKE = dict(implementation="fake", base_model="fake", draft_model=None, draft_mode="tree",
            max_new_tokens=16, max_seq_len=256)


@pytest.mark.parametrize("branching", BRANCHINGS)
def test_fake_tree_equals_jax_and_baseline(branching):
    """Tree generate on the fake model (its heads are exact): ids, proposed,
    accepted, bonus, steps equal JAX's Engine and the host loop, logprobs
    within 1e-5 of JAX's; ids equal the greedy baseline's; every step
    accepts at least one node, proposed grows by num_nodes a step."""
    kw = dict(FAKE, tree={"branching": branching})
    prompt = "tree speculation test"
    got = Engine(EngineConfig(**kw), device="cpu").generate(prompt)
    host = Engine(EngineConfig(**kw), device="cpu",
                  flags=EnvFlags(sync_steps=True)).generate(prompt)
    want = JaxEngine(JaxEngineConfig(**kw)).generate(prompt)
    base = Engine(EngineConfig(**dict(FAKE, draft_mode="vanilla")), device="cpu").generate(prompt)
    for key in KEYS:
        assert got[key] == want[key] == host[key], (key, got[key], want[key], host[key])
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], rtol=0, atol=1e-5)
    assert got["generated_ids"] == base["generated_ids"]
    np.testing.assert_allclose(got["token_logprobs"], base["token_logprobs"], rtol=0, atol=1e-5)
    n = TreeConfig(tuple(branching)).num_nodes
    assert got["proposed"] == n * got["steps"] and got["accepted"] >= got["steps"] - 1
    assert got["draft_mode"] == "tree"


MULT = 10


@functools.lru_cache(maxsize=None)
def _target():
    m = get_model("llama-tiny", "hf", rng=jax.random.PRNGKey(2), dtype=jnp.float32)
    m.params = jax.tree_util.tree_map(lambda a: a * MULT if a.ndim >= 2 else a, m.params)
    return m


TINY = dict(base_model="llama-tiny", draft_model=None, draft_mode="tree", max_new_tokens=24,
            max_seq_len=256, dtype="float32")
PROMPTS = ["abcabcabc xyz abcabc", "abc " * 8, "hello world"]
LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged", kv_page_size=16)}


def _jax(**kw):
    return JaxEngine(JaxEngineConfig(implementation="hf", kv_lazy_pages=False, **dict(TINY, **kw)),
                     target_model=_target())


def _port(jeng, flags=None, **kw):
    return Engine(EngineConfig(**dict(TINY, **kw)), device="cpu", flags=flags,
                  target_params=params_from_jax(_target().params),
                  draft_params=params_from_jax(jeng._draft_params))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_llama_tiny_tree_equals_jax(layout):
    """llama-tiny f32, tree [3, 2] with random heads (JAX's, carried over),
    at B=1 and B=3: ids, proposed, accepted, bonus and steps equal JAX's and
    the host loop's; logprobs within 1e-4 of JAX's; ids equal the greedy
    baseline's; acceptance above 0."""
    kw = dict(LAYOUTS[layout], medusa={"head_init": "random"})
    jeng = _jax(**kw)
    eng, host = _port(jeng, **kw), _port(jeng, EnvFlags(sync_steps=True), **kw)
    base = _port(jeng, **dict(kw, draft_mode="vanilla"))
    for batch in (1, 3):
        prompts = PROMPTS[:batch]
        got, want, again = (e.generate_batch(prompts) for e in (eng, jeng, host))
        for g, w, h in zip(got, want, again, strict=True):
            for key in KEYS:
                assert g[key] == w[key] == h[key], (key, g[key], w[key], h[key])
            np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0,
                                       atol=1e-4)
        assert sum(r["accepted"] for r in got) > 0
        assert ([r["generated_ids"] for r in got]
                == [r["generated_ids"] for r in base.generate_batch(prompts)])


def _committed_rows(cache, lengths, paged):
    """Per lane, every layer's K and V rows [0, L-1) (what the cache
    invariant holds), gathered through the table for a paged cache."""
    k, v = cache.k, cache.v
    if paged:
        k = torch.stack([gather_pages(k[i], cache.table) for i in range(k.shape[0])])
        v = torch.stack([gather_pages(v[i], cache.table) for i in range(v.shape[0])])
    return [(k[:, b, :, :n], v[:, b, :, :n]) for b, n in enumerate((lengths - 1).tolist())]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cache_after_compaction_equals_jax(layout):
    """The tree step a step at a time on both sides from the same prefill
    (B=2, tree [3, 2], identity heads, the prompt block of two prompts of
    the llama-tiny runs above, which accept nodes): after every step tokens,
    lengths and accepted equal JAX's, and every committed KV row, compacted
    from its tree slot, is within 1e-4 of the largest |row| of JAX's (two
    f32 forwards of x10 weights; measured 5.5e-5 in layer 1)."""
    paged = layout == "paged"
    tree, T, P = (3, 2), 128, 16
    jm, heads = _target(), _jax()
    proj = heads._draft_params
    block, plens, _ = _port(heads)._prompt_block(PROMPTS[:2])
    kv = dict(paged=paged, page_size=P)
    if paged:
        table = (np.arange(2 * (T // P))[::-1].reshape(2, T // P) + 1).astype(np.int32)
        kv.update(n_pages=2 * (T // P) + 1, table=table)
    jstate = jax_init_state(jm, None, 2, T, max_new_tokens=40, **{
        k_: (jnp.asarray(v_) if k_ == "table" else v_) for k_, v_ in kv.items()})
    jstate = jax_prefill(jm, None, prefill_draft=False)(jm.params, {}, jstate,
                                                       jnp.asarray(block), jnp.asarray(plens))
    jstep = jax_tree_step(jm, JaxTreeConfig(tree), jit=False)
    target = get_port_model()
    if paged:
        kv["table"] = torch.from_numpy(kv["table"])
    state = init_state(target, None, 2, T, "cpu", max_new_tokens=40, **kv)
    state = make_prefill(target, None, hidden=True)(state, torch.from_numpy(block),
                                                   torch.from_numpy(plens))
    step = make_tree_spec_step(target, TreeConfig(tree), draft_params=params_from_jax(proj))
    moved = 0
    for _ in range(10):
        jstate = jstep(jm.params, proj, jstate)
        state = step(state)
        for name in ("tokens", "lengths", "accepted"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        jk = jnp.stack([jpaged.gather_pages(jstate.target_cache.k[i], jstate.target_cache.table)
                        for i in range(2)]) if paged else jstate.target_cache.k
        jv = jnp.stack([jpaged.gather_pages(jstate.target_cache.v[i], jstate.target_cache.table)
                        for i in range(2)]) if paged else jstate.target_cache.v
        for b, (k_b, v_b) in enumerate(_committed_rows(state.target_cache, state.lengths, paged)):
            n = k_b.shape[2]
            for got, want in ((k_b, jk[:, b, :, :n]), (v_b, jv[:, b, :, :n])):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-4 * np.abs(want).max())
        moved += int((state.accepted > 0).sum())
    assert moved > 0  # some step accepted nodes: their rows were compacted


@functools.lru_cache(maxsize=None)
def get_port_model():
    from llm_inference_lab_tpu_torch.models.registry import create

    return create("llama-tiny", device="cpu", dtype=torch.float32,
                  params=params_from_jax(_target().params))


SERVE_REQUESTS = [("abcabcabc xyz abcabc", 20), ("hello world", 9), ("ab" * 10, 16),
                  ("abc " * 8, 12)]


def _serve(b):
    for prompt, budget in SERVE_REQUESTS:
        b.submit(prompt, max_new_tokens=budget)
    b._admit_pending()
    for _ in range(200):
        if not any(s is not None for s in b._slots):
            break
        b.step_chunk(1)
        b._retire_finished()
        b._admit_pending()
    return [b._done[i].result for i in sorted(b._done)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batcher_equals_jax_and_generate(layout):
    """The tree through the batcher (2 slots, 4 requests, one step a poll;
    headroom from the tree's num_nodes + 1): ids, proposed and accepted
    equal JAX's batcher; ids equal the start of the port's generate."""
    kw = LAYOUTS[layout]
    jeng = _jax(**kw)
    want = _serve(JaxBatcher(jeng, n_slots=2))
    eng = _port(jeng, kv_lazy_pages=False, **kw)
    assert eng._max_k == 10
    got = _serve(ContinuousBatcher(eng, n_slots=2))
    for g, w in zip(got, want, strict=True):
        for key in ("generated_ids", "proposed", "accepted", "finish_reason"):
            assert g[key] == w[key], (key, g[key], w[key])
    for r, (prompt, budget) in zip(got, SERVE_REQUESTS):
        assert r["generated_ids"] == eng.generate(prompt)["generated_ids"][:budget]


def test_tree_refusals():
    """A ring, a non-greedy policy or an adaptive controller in tree mode is
    refused; a binding window with the tree mask raises in the forward (as
    in JAX); a tree of 33 rows takes two ancestry words a row (no limit of
    32 rows: every bit of a full mask set, the second word's bit 0 only)."""
    for kw in (dict(kv_ring=True, prefill_chunk=32), dict(policy="typical"),
               dict(controller="adaptive")):
        with pytest.raises((ValueError, NotImplementedError)):
            EngineConfig(**dict(TINY, **kw)).validate()
    q, k, v, ks, vs, anc, start = _tree_inputs("f32", seed=5)
    pos = torch.zeros(q.shape[:2], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        attend(q, k, v, pos, tree_mask=anc, chunk_start=start, window=16)
    big = torch.ones((33, 33), dtype=torch.bool)
    assert torch.equal(tree_bits(big), torch.full((33, 2), -1, dtype=torch.int32)
                       .index_fill_(1, torch.tensor([1]), 1))


@pytest.mark.parametrize("grammar", [dict(constrain="json"), dict(tools=[{"name": "ping"}])])
def test_tree_refuses_a_grammar(grammar):
    """Constrained decoding in tree mode raises JAX's ValueError in both
    packages (the tree walks its own path: no FSM walk over it)."""
    cfg = dict(implementation="fake", base_model="fake", draft_model=None, draft_mode="tree",
               **grammar)
    with pytest.raises(ValueError, match="not supported in tree mode"):
        JaxEngine(JaxEngineConfig(**cfg))
    with pytest.raises(ValueError, match="not supported in tree mode"):
        Engine(EngineConfig(max_seq_len=256, **cfg), device="cpu")
