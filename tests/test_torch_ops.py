"""Port parity: decode attention (flash_decode) and verify_prefix.

The same numpy inputs (fixed seeds) go through the JAX package (its Pallas
kernels in interpret mode, and its XLA references) and through
llm_inference_lab_tpu_torch on the CPU, where each op runs its plain
PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu.ops.pallas.flash_decode import flash_decode_attention
from llm_inference_lab_tpu.ops.pallas.verify_pallas import verify_prefix_pallas
from llm_inference_lab_tpu.ops.verify import verify_prefix_xla
from llm_inference_lab_tpu_torch.core.policies import longest_prefix
from llm_inference_lab_tpu_torch.ops.attention import attend
from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
from llm_inference_lab_tpu_torch.ops.verify import verify_prefix, verify_prefix_plain


def _attn_inputs(S, seed, B=2, H=6, KVH=2, T=256, D=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32)
    base = rng.integers(0, T - S, (B,))
    pos = (base[:, None] + np.arange(S)[None]).astype(np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("S", [1, 2])
def test_flash_decode_matches_pallas_on_live_rows(S):
    """(c) the plain flash_decode against flash_decode_attention
    (interpret=True) at D=128, T=256, GQA group 3. f32; tolerance 2e-5
    absolute (outputs are O(1) averages of N(0,1) values; the two sum the
    softmax in another order)."""
    q, k, v, pos = _attn_inputs(S, seed=S)
    ref = flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), interpret=True, block_t=128)
    got = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, pos)))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("S", [1, 2, 5])
def test_flash_decode_matches_attend_xla_with_dead_row(S):
    """(c) against attend_xla everywhere, including a dead row (position -1,
    an empty slot) that must be exactly zero. The Pallas tile body returns
    the mean of V on such a row (it masks with a finite -1e30): the port
    follows attend_xla, and this test pins the divergence."""
    q, k, v, pos = _attn_inputs(S, seed=10 + S)
    pos[1, 0] = -1  # dead row
    tq = tuple(torch.from_numpy(a) for a in (q, k, v, pos))
    ref = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    got = attend(*tq).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    assert np.all(got[1, 0] == 0.0)
    pallas = np.asarray(flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(pos), interpret=True, block_t=128))
    np.testing.assert_allclose(pallas[1, 0], v[1].mean(axis=1).repeat(3, axis=0), atol=1e-5)


def test_flash_decode_row_independent_of_batching():
    """A query row's output does not depend on the other rows of the call:
    the verify forward (S = 2) and the baseline step (S = 1) agree exactly."""
    q, k, v, pos = _attn_inputs(2, seed=3)
    tq = [torch.from_numpy(a) for a in (q, k, v, pos)]
    both = flash_decode_plain(*tq)
    first = flash_decode_plain(tq[0][:, :1], tq[1], tq[2], tq[3][:, :1])
    np.testing.assert_allclose(first.numpy(), both[:, :1].numpy(), rtol=0, atol=1e-6)


def test_attend_refuses_unported_options():
    q, k, v, pos = (torch.from_numpy(a) for a in _attn_inputs(1, seed=4))
    for kw in ({"window": 16}, {"softcap": 30.0}, {"ring_len": 256}, {"scale": 0.1},
               {"tree_mask": torch.ones(1, 1, dtype=torch.bool)}):
        with pytest.raises(NotImplementedError):
            attend(q, k, v, pos, **kw)


def _verify_inputs(B=4, K=4, V=1000, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (B, K, V)).astype(np.float32)
    draft = np.argmax(logits, -1).astype(np.int32)
    draft[1, 2] = (draft[1, 2] + 1) % V  # mismatch at k=2: accept 2
    draft[2, 0] = (draft[2, 0] + 1) % V  # mismatch at k=0: accept 0
    # Forced tie between columns 7 and 900: the lowest index wins.
    logits[3, 1, 7] = logits[3, 1, 900] = logits[3, 1].max() + 1.0
    draft[3, 1] = 7
    # A NaN in a row whose argmax would otherwise match: it must reject.
    logits[0, 3, 5] = np.nan
    return draft, logits


def test_verify_prefix_matches_pallas_exactly():
    """(d) accept_len and mask equal verify_prefix_pallas(interpret=True)
    exactly, with a forced tie and a NaN row."""
    draft, logits = _verify_inputs()
    n_ref, m_ref = verify_prefix_pallas(jnp.asarray(draft), jnp.asarray(logits), interpret=True)
    n, m = verify_prefix(torch.from_numpy(draft), torch.from_numpy(logits))
    assert n.dtype == torch.int32 and m.dtype == torch.bool
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(n.numpy(), [3, 2, 0, 4])


def test_verify_prefix_all_nan_row_rejects_unlike_xla():
    """(d) an all-NaN row: the Pallas kernel and the port reject it, while
    verify_prefix_xla argmaxes it to 0 and accepts a draft token 0."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 1, (2, 2, 1000)).astype(np.float32)
    draft = np.argmax(logits, -1).astype(np.int32)
    logits[0, 0, :] = np.nan
    draft[0, 0] = 0
    n_xla, _ = verify_prefix_xla(jnp.asarray(draft), jnp.asarray(logits))
    n_pl, _ = verify_prefix_pallas(jnp.asarray(draft), jnp.asarray(logits), interpret=True)
    n, _ = verify_prefix_plain(torch.from_numpy(draft), torch.from_numpy(logits))
    assert int(n_xla[0]) == 2 and int(n_pl[0]) == 0 and int(n[0]) == 0
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_pl))


def test_longest_prefix_reads_the_first_k_rows():
    """The policy passes the first K rows of the [B, K+1, V] verify logits as
    a strided view, and matches the JAX policy's result."""
    from llm_inference_lab_tpu.core.policies import longest_prefix as jax_longest_prefix

    draft, logits = _verify_inputs(seed=2)
    logits[0, 3, 5] = 0.0  # no NaN: compare with the registry op path too
    full = np.concatenate([logits, np.random.default_rng(3).normal(0, 1, (4, 1, 1000))
                          .astype(np.float32)], axis=1)
    got = longest_prefix(torch.from_numpy(draft), torch.from_numpy(full))
    ref = jax_longest_prefix(None, jnp.asarray(draft), None, jnp.asarray(full))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
