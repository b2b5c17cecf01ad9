"""Kernel F's address map and split-and-combine, in their plain versions, on
the CPU.

Kernel F is kernel D's tensor-core body with a page table as its address
map: key j of sequence b is row j % P of page table[b, j // P], loaded only
in the block's live range [lowest first visible key, largest position], and
the keys are cut into fixed splits combined in ascending order as D does.
``paged_flash_split_plain`` writes that arithmetic plainly. Over shuffled
pages it must equal ``flash_decode_split_plain`` over the same keys laid out
contiguously exactly (torch.equal: the same keys, the same order of every
sum), also when every pool row outside the live ranges is NaN (dummy page 0,
unused pages and table entries, pages below the window and past the last
position), and it must match the JAX package's Pallas
``paged_flash_attention`` (interpret mode) on live rows within 2e-5 absolute,
the tolerance of tests/test_torch_paged.py (f32 outputs are O(1) averages of
N(0, 1) values, the softmax summed in another order). Page sizes 16, 32, 64
and 128, S = 1 and 5, a window whose edge falls inside a page, dead rows
(position -1, and a sequence with no live row), f32 and int8 pools. Inputs
are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops.pallas.paged_flash import paged_flash_attention
from llm_inference_lab_tpu_torch.models.base import quantize_rows
from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_split_plain
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_split_plain, paged_keys

ATOL = 2e-5
SPLIT_SMALL = 64  # several splits over the 384 keys
B, KVH, GROUP, D, T = 3, 2, 2, 32, 384
LAST = (300, 150, -1)  # each sequence's last position; sequence 2 has no live row
WINDOW = 100  # sequence 0 at S = 5 first sees key 197: inside a page of 16, 32, 64 or 128


def _inputs(P, S, int8, window, seed):
    """q, positions; contiguous keys [B, KVH, T, D] (and scales); the same
    keys in shuffled pools [N, KVH, P, D] through table [B, T / P] (page 0
    and two more pages unused); and the pools again with NaN (int8: bytes 127
    and NaN scales) at every row outside the sequences' live ranges."""
    rng = np.random.default_rng(seed)
    M = T // P
    N = B * M + 3
    q = torch.from_numpy(rng.normal(0, 1, (B, S, KVH * GROUP, D)).astype(np.float32))
    pos = np.stack([np.arange(S) + last - S + 1 if last >= 0 else np.full(S, -1)
                    for last in LAST]).astype(np.int32)
    if S > 1:
        pos[1, 0] = -1  # a dead row beside live ones
    pos = torch.from_numpy(pos)
    kv = [torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32)) for _ in "kv"]
    cont = [*quantize_rows(kv[0]), *quantize_rows(kv[1])] if int8 else kv
    cont = [cont[0], cont[2], cont[1], cont[3]] if int8 else cont  # k, v, k_scale, v_scale
    table = torch.from_numpy((rng.permutation(N - 1)[: B * M].reshape(B, M) + 1).astype(np.int32))
    live = torch.zeros((B, T), dtype=torch.bool)
    for b in range(B):
        p = pos[b][pos[b] >= 0]
        if p.numel():
            lo = max(int(p.min()) - window + 1, 0) if window else 0
            live[b, lo:int(p.max()) + 1] = True
    pools, poisoned = [], []
    for src in cont:
        tail = src.shape[3:]
        pages = src.reshape(B, KVH, M, P, *tail).transpose(1, 2).reshape(B * M, KVH, P, *tail)
        pool = torch.zeros((N, KVH, P, *tail), dtype=src.dtype)
        pool[table.flatten().long()] = pages
        bad = torch.full_like(pool, 127 if src.dtype == torch.int8 else float("nan"))
        mask = live.reshape(B * M, P)[:, None, :].expand(B * M, KVH, P)
        keep = bad[table.flatten().long()]
        keep[mask] = pages[mask]
        bad[table.flatten().long()] = keep
        pools.append(pool)
        poisoned.append(bad)
    return q, pos, cont, pools, poisoned, table


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [None, WINDOW], ids=["no-window", "window"])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_paged_split_equals_contiguous_split_and_pallas(P, S, window, int8):
    q, pos, cont, pools, poisoned, table = _inputs(P, S, int8, window, seed=P + 10 * S)
    opts = dict(window=window)
    ref = flash_decode_split_plain(q, cont[0], cont[1], pos, *cont[2:], split=SPLIT_SMALL,
                                   **opts)
    got = paged_flash_split_plain(q, pools[0], pools[1], pos, table, *pools[2:],
                                  split=SPLIT_SMALL, **opts)
    assert torch.equal(got, ref)
    # No row outside the live ranges is read: NaN there changes nothing.
    clean = paged_flash_split_plain(q, poisoned[0], poisoned[1], pos, table, *poisoned[2:],
                                    split=SPLIT_SMALL, **opts)
    assert torch.isfinite(clean).all() and torch.equal(clean, ref)
    assert torch.all(got[2] == 0) and (S == 1 or torch.all(got[1, 0] == 0))  # dead rows
    # The Pallas kernel on the live rows (it returns the mean of V on dead
    # ones). With a window, a dead row beside live ones clamps the Pallas
    # page sweep's start to page 0 while the sweep keeps its window-bounded
    # length, so the live rows of that sequence miss their last pages: those
    # rows are left out (sequence 1 at S > 1).
    jp = jnp.asarray(pos.numpy())
    pallas = paged_flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(pools[0].numpy()), jnp.asarray(pools[1].numpy()), jp,
        *(jnp.asarray(t.numpy()) for t in pools[2:]), table=jnp.asarray(table.numpy()),
        interpret=True, window=window)
    rows = pos >= 0
    if window is not None:
        rows &= (pos >= 0).all(1, keepdim=True)
    np.testing.assert_allclose(got[rows].numpy(), np.asarray(pallas)[rows.numpy()], rtol=0,
                               atol=ATOL)


def test_paged_keys_read_only_the_live_pages():
    """The address map reads table entries only for the pages that hold a
    key of a sequence's live range: entries past them, below the window and
    of a sequence with no live row may be anything, even out of range."""
    P, M = 16, 8
    pool = torch.arange(5 * 1 * P, dtype=torch.float32).reshape(5, 1, P)
    table = torch.full((3, M), 10 ** 6, dtype=torch.int32)
    table[0, 2:4] = torch.tensor([3, 1])  # positions 40..50 with a window of 12: pages 2 and 3
    table[1, 0] = 4
    pos = torch.tensor([[49, 50], [-1, 5], [-1, -1]], dtype=torch.int32)
    keys = paged_keys(pool, table, pos, window=12)
    want = torch.zeros((3, 1, M * P))
    want[0, 0, 38:48] = pool[3, 0, 6:16]
    want[0, 0, 48:51] = pool[1, 0, 0:3]
    want[1, 0, 0:6] = pool[4, 0, 0:6]
    assert torch.equal(keys, want)
