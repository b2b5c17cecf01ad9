"""Kernel H's plain version (ops/kv_write.py), one layer's K and V rows
stored in the KV cache in the index form (KVSlots), against the JAX
package's writers: models/base.py update_cache_layer (contiguous, and the
rolling-buffer ring with a block shorter and longer than R),
scatter_stack_layer (the stacked cache at a layer index) and models/paged.py
update_paged_layer (a page pool through a shuffled table).

Every byte of the cache and every scale must equal JAX's exactly, for a
bf16 cache and an int8 one (rows quantized as JAX's _quantize_rows: amax,
max(amax, 1e-8) / 127, round half to even, clip), from bf16 and f32 rows.
The caches start from random bytes and scales, so rows that no write
reaches must keep theirs. The sources are the views the forward passes
(models/transformer.py _attn_block): K the RoPE output's KV heads
qk[:, :, H:], V a reshaped slice of the QKV projection, neither contiguous.
Head dims 64, 96, 128 and 256 with 8, 1, 4 and 2 KV heads. The write
starts are drawn by hypothesis within the headroom the engine keeps (so no
two rows clip to one slot: their order is unspecified in JAX too); the ring
takes any start.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_inference_lab_tpu.models import base as jbase
from llm_inference_lab_tpu.models import paged as jpaged
from llm_inference_lab_tpu_torch.models.base import (
    KVCache,
    cache_slots,
    slice_slots,
    write_cache_layer,
)
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache, page_slots, write_paged_layer
from llm_inference_lab_tpu_torch.ops.kv_write import kv_write
from test_torch_decode_loop import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

HEADS = {64: 8, 96: 1, 128: 4, 256: 2}  # head dim: KV heads
H, B, L = 2, 2, 2  # query heads beside the KV heads in the projection; lanes; layers
T, R, P, PAGES, N = 32, 16, 8, 3, 9  # contiguous T, ring R, page size, pages a lane, pool
KINDS = {"bf16": (torch.bfloat16, torch.bfloat16), "int8": (torch.bfloat16, torch.int8),
         "f32-int8": (torch.float32, torch.int8)}  # source rows' type, cache's type
# layout: (rows S to draw from, the largest start given S)
LAYOUTS = {"contiguous": ((1, 5), lambda S: T - S), "stack": ((1, 5), lambda S: T - S),
           "ring": ((1, 5), lambda S: 200), "ring_longer_than_r": ((R + 5,), lambda S: 200),
           "paged": ((1, 5), lambda S: PAGES * P - S)}
JAX_TYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int8: jnp.int8}


def _bits(a):
    """An array's bytes as integers, so bf16 compares bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _cache(rng, shape, kind):
    """(the port's k, v, k_scale, v_scale; JAX's) from random bytes: int8
    values with positive scales, or values of the cache's float type (a
    JAX bf16 cache gets scales of ones, which it never writes)."""
    _, dst = KINDS[kind]
    if dst == torch.int8:
        kv = [torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)) for _ in range(2)]
        sc = [torch.from_numpy(rng.uniform(0.01, 1, shape[:-1]).astype(np.float32))
              for _ in range(2)]
        return kv + sc, [jnp.asarray(t.numpy()) for t in kv + sc]
    kv = [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dst) for _ in range(2)]
    ones = [jnp.ones(shape[:-1], jnp.float32)] * 2
    return kv + [None, None], [jnp.asarray(t.float().numpy()).astype(JAX_TYPES[dst])
                               for t in kv] + ones


def _sources(rng, S, KVH, D, src):
    """(k_new, v_new) as the forward passes them (views, not contiguous),
    and JAX's contiguous copies of the same values."""
    qkv = torch.from_numpy(rng.normal(0, 1, (B, S, (H + 2 * KVH) * D)).astype(np.float32))
    qkv = qkv.to(src)
    qk = qkv[..., :(H + KVH) * D].reshape(B, S, H + KVH, D) * 1  # the RoPE output: a new tensor
    k_new, v_new = qk[:, :, H:], qkv[..., (H + KVH) * D:].reshape(B, S, KVH, D)
    assert not k_new.is_contiguous() and not v_new.is_contiguous()
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(JAX_TYPES[src])  # noqa: E731
    return (k_new, v_new), (to_jax(k_new), to_jax(v_new))


def _write(layout, kind, D, S, start, seed):
    """The port's write and JAX's on the same cache and rows: (got, want),
    each the list k, v, k_scale, v_scale of the written layer."""
    KVH = HEADS[D]
    src, dst = KINDS[kind]
    rng = np.random.default_rng(seed)
    start_t, start_j = torch.tensor(start, dtype=torch.int32), jnp.asarray(start, jnp.int32)
    (k_new, v_new), (jk, jv) = _sources(rng, S, KVH, D, src)
    if layout == "paged":
        table = (rng.permutation(N - 1)[:B * PAGES].reshape(B, PAGES) + 1).astype(np.int32)
        got, want = _cache(rng, (L, N, KVH, P, D), kind)
        cache = PagedKVCache(got[0], got[1], torch.from_numpy(table), got[2], got[3])
        write_paged_layer(cache, 1, k_new, v_new,
                          page_slots(cache.table, start_t, S, P))
        want = jpaged.update_paged_layer(*(w[1] for w in want), jk, jv, start_j,
                                         jnp.asarray(table))
        return [None if t is None else t[1] for t in got], want
    T_ = R if layout.startswith("ring") else T
    ring = R if layout.startswith("ring") else None
    got, want = _cache(rng, (L, B, KVH, T_, D), kind)
    write_cache_layer(KVCache(*got), 1, k_new, v_new, cache_slots(start_t, S, T_, ring))
    if layout == "stack":
        want = jbase.scatter_stack_layer(*want, jk, jv, start_j, jnp.int32(1))
        return got, want
    want = jbase.update_cache_layer(*(w[1] for w in want), jk, jv, start_j, ring_len=ring)
    return [None if t is None else t[1] for t in got], want


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("D", list(HEADS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_write_equals_jax_bit_for_bit(layout, D, kind):
    """The plain kv_write (through write_cache_layer and write_paged_layer
    with cache_slots and page_slots) equals JAX's writer byte for byte,
    scales included, at starts drawn by hypothesis."""
    sizes, last = LAYOUTS[layout]

    @settings(max_examples=5, deadline=None, database=None)
    @given(data=st.data())
    def check(data):
        S = data.draw(st.sampled_from(sizes))
        start = data.draw(st.lists(st.integers(0, last(S)), min_size=B, max_size=B))
        got, want = _write(layout, kind, D, S, start, seed=sum(start) + S)
        int8 = KINDS[kind][1] == torch.int8
        for name, g, w in zip(("k", "v", "k_scale", "v_scale"), got, want):
            if g is None:
                assert not int8 and name.endswith("scale")
                continue
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{name} at {start}")

    check()


def test_cpu_wrapper_runs_plain_without_a_launch():
    """On a CPU cache kv_write runs its plain version (no launch counted)
    and writes only the slots it is given."""
    before = kv_write.launches
    got, want = _write("contiguous", "int8", 128, 5, [0, 20], seed=0)
    assert kv_write.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("B", [1, 3])
def test_slots_are_the_kernels_contiguous_int32(B):
    """What kernel H's wrapper takes (it raises on anything else): contiguous
    int32 [n] indices of one length from cache_slots (a ring, a block longer
    than it), page_slots and slice_slots, at B = 1 too, where a reshape of
    an expanded index would be a stride-0 view."""
    start = torch.arange(B, dtype=torch.int32) * 3 + 2
    table = torch.arange(B * PAGES, dtype=torch.int32).reshape(B, PAGES) + 1
    for slots, n in ((cache_slots(start, 5, T), 5 * B), (cache_slots(start, 5, R, R), 5 * B),
                     (cache_slots(start, R + 5, R, R), R * B),
                     (page_slots(table, start, 5, P), 5 * B),
                     (slice_slots(start, 5, 4, 8), None)):
        for t in slots:
            assert t.dtype == torch.int32 and t.is_contiguous() and t.dim() == 1, t
            assert t.shape[0] == (n if n is not None else slots.b.shape[0]) > 0
