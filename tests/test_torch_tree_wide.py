"""Tree speculation past 31 nodes (a verify chunk of S > 32 rows, whose
ancestry mask takes W = ceil(S / 32) words a row) against the JAX package
on the CPU.

The kernels' form of the mask (ops/flash_decode.py tree_bits, int32
[S, W]) decodes back to the mask (tree_mask_from_bits, the plain decoder)
for random masks of S in 1-130 (hypothesis), and for S <= 32 its one word
a row is the one-word form (int32 [S]), bit for bit. The
topology of trees of depth 3 with 40, 85 and 102 nodes equals JAX's
TreeConfig.build. The plain versions of D's and F's tree variant equal
attend_xla's and paged_attend_xla's tree branch at S = 41 and 103 (f32,
1e-5). llama-tiny (test_torch_treespec.py's f32 weights and JAX's random
heads, carried over) with the trees [4, 3, 2] (40 nodes) and [5, 4, 3] (85
nodes): Engine.generate, contiguous and paged, gives JAX's tree engine's
ids, proposed, accepted, bonus and steps (logprobs within 1e-4), and the
paged batcher gives JAX's batcher's. The same [4, 3, 2] tree at seq=2 is in
test_torch_mesh_serving.py's launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.treespec import TreeConfig as JaxTreeConfig
from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu.ops.paged_attention import paged_attend_xla
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.treespec import TreeConfig
from llm_inference_lab_tpu_torch.ops.attention import attend, paged_attend
from llm_inference_lab_tpu_torch.ops.flash_decode import tree_bits, tree_mask_from_bits
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_treespec import KEYS, PROMPTS, SERVE_REQUESTS, _jax, _port, _serve

pytestmark = pytest.mark.usefixtures("one_thread")

WIDE = [(4, 3, 2), (5, 4, 3), (6, 4, 3)]  # 40, 85 and 102 nodes


def _one_word(mask: torch.Tensor) -> torch.Tensor:
    """The one-word form of a mask of S <= 32 rows: int32 [S], bit j of row
    s set iff mask[s, j] (bit 31 as the sign)."""
    S = mask.shape[0]
    word = (mask.long() * (torch.ones((S,), dtype=torch.int64) << torch.arange(S))).sum(-1)
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


@settings(max_examples=60, deadline=None, database=None)
@given(S=st.integers(1, 130), seed=st.integers(0, 2 ** 31 - 1),
       density=st.floats(0.0, 1.0))
def test_tree_bits_round_trip(S, seed, density):
    """Random masks of S rows go through tree_bits (int32 [S, ceil(S / 32)])
    and tree_mask_from_bits unchanged; with S <= 32 the one word a row is
    the one-word form, bit for bit."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((S, S), generator=g) < density
    bits = tree_bits(mask)
    assert bits.dtype == torch.int32 and bits.shape == (S, -(-S // 32))
    assert torch.equal(tree_mask_from_bits(bits, S), mask)
    if S <= 32:
        assert torch.equal(bits[:, 0], _one_word(mask))


@pytest.mark.parametrize("branching", WIDE)
def test_wide_topology_equals_jax(branching):
    """Parents, depths, ranks and the ancestry mask of depth-3 trees past 31
    nodes equal JAX's exactly; the kernels' words decode to the mask."""
    ours, theirs = TreeConfig(branching), JaxTreeConfig(branching)
    assert (ours.depth, ours.num_nodes) == (theirs.depth, theirs.num_nodes)
    for a, b in zip(ours.build(), theirs.build(), strict=True):
        np.testing.assert_array_equal(a, b)
    anc = torch.from_numpy(ours.build()[3])
    assert anc.shape[0] == ours.num_nodes + 1 > 32
    assert torch.equal(tree_mask_from_bits(tree_bits(anc), anc.shape[0]), anc)


@pytest.mark.parametrize("branching", [(4, 3, 2), (6, 4, 3)])
def test_wide_plain_tree_attention_equals_attend_xla(branching):
    """attend and paged_attend with the mask of S = 41 and 103 rows (D's and
    F's tree variant's plain versions, f32) against attend_xla's and
    paged_attend_xla's tree branch: 1e-5. One chunk starts mid-cache, one
    at slot -1."""
    rng = np.random.default_rng(len(branching) + sum(branching))
    anc = TreeConfig(branching).build()[3]
    S, B, H, KVH, D, T, P = anc.shape[0], 2, 4, 2, 32, 256, 16
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32) for _ in "kv")
    start = np.array([T - S - 37, -1], np.int32)
    pos = np.zeros((B, S), np.int32)
    want = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), tree_mask=jnp.asarray(anc),
                                 chunk_start=jnp.asarray(start)))
    tq, tk, tv, tanc, tstart, tpos = (torch.from_numpy(x) for x in (q, k, v, anc, start, pos))
    got = attend(tq, tk, tv, tpos, tree_mask=tanc, chunk_start=tstart)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    M = T // P
    table = (rng.permutation(B * M) + 1).reshape(B, M).astype(np.int32)
    pools = []
    for x in (k, v):
        pool = np.zeros((B * M + 1, KVH, P, D), np.float32)
        pool[table] = x.reshape(B, KVH, M, P, D).transpose(0, 2, 1, 3, 4)
        pools.append(pool)
    want_p = np.asarray(paged_attend_xla(jnp.asarray(q), jnp.asarray(pools[0]),
                                         jnp.asarray(pools[1]), jnp.asarray(pos),
                                         table=jnp.asarray(table), tree_mask=jnp.asarray(anc),
                                         chunk_start=jnp.asarray(start)))
    got_p = paged_attend(tq, torch.from_numpy(pools[0]), torch.from_numpy(pools[1]), tpos,
                         torch.from_numpy(table), tree_mask=tanc, chunk_start=tstart)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("branching", [(4, 3, 2), (5, 4, 3)], ids=["40nodes", "85nodes"])
def test_wide_tree_generate_equals_jax(branching, layout):
    """llama-tiny f32 with JAX's random heads, at B=1 and B=2: ids,
    proposed, accepted, bonus and steps equal JAX's tree engine; logprobs
    within 1e-4; some nodes accepted."""
    kw = dict(tree={"branching": list(branching)}, medusa={"head_init": "random"})
    if layout == "paged":
        kw.update(kv_layout="paged", kv_page_size=16)
    jeng = _jax(**kw)
    eng = _port(jeng, **kw)
    assert eng._max_k == TreeConfig(branching).num_nodes + 1
    for batch in (1, 2):
        got, want = eng.generate_batch(PROMPTS[:batch]), jeng.generate_batch(PROMPTS[:batch])
        for g, w in zip(got, want, strict=True):
            for key in KEYS:
                assert g[key] == w[key], (key, g[key], w[key])
            np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0,
                                       atol=1e-4)
        assert sum(r["accepted"] for r in got) > 0


@pytest.mark.parametrize("branching", [(4, 3, 2), (5, 4, 3)], ids=["40nodes", "85nodes"])
def test_wide_tree_paged_batcher_equals_jax(branching):
    """The paged batcher (2 slots, 4 requests, one step a poll): ids,
    proposed, accepted and finish reasons equal JAX's batcher; ids equal
    the start of the port's generate."""
    kw = dict(tree={"branching": list(branching)}, medusa={"head_init": "random"},
              kv_layout="paged", kv_page_size=16)
    jeng = _jax(**kw)
    want = _serve(JaxBatcher(jeng, n_slots=2))
    eng = _port(jeng, kv_lazy_pages=False, **kw)
    got = _serve(ContinuousBatcher(eng, n_slots=2))
    for g, w in zip(got, want, strict=True):
        for key in ("generated_ids", "proposed", "accepted", "finish_reason"):
            assert g[key] == w[key], (key, g[key], w[key])
    for r, (prompt, budget) in zip(got, SERVE_REQUESTS):
        assert r["generated_ids"] == eng.generate(prompt)["generated_ids"][:budget]
