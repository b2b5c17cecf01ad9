"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips on a machine without a CUDA card:
a kernel has no CPU mode. The file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to the same versions at every shape of
the main path; these tests are the quick check at a few of them.
"""

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
from llm_inference_lab_tpu_torch.ops.quant import quantize_int4
from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
from llm_inference_lab_tpu_torch.ops.verify import verify_prefix, verify_prefix_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(3072, 5120), (8192, 2048)])
def test_int4_kernel_matches_plain(card, K, N):
    """bf16 output: tolerance 1e-2 of the largest magnitude (bf16 rounding of
    the output, 2^-8 relative, plus f32 summation order)."""
    rng = np.random.default_rng(K + N)
    w = quantize_int4(torch.from_numpy(rng.normal(0, 0.02, (K, N)).astype(np.float32)))
    wd, ws = w.data.to(card), w.scale.to(card)
    outs = {}
    for M in (1, 2, 160):
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32)).to(card).bfloat16()
        before = quant_matmul.launches
        got = quant_matmul(x, wd, ws).float()
        assert quant_matmul.launches == before + 1
        ref = quant_matmul_plain(x, wd, ws).float()
        assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()
        outs[M] = (x, got)
    # Row 0 rounds identically at M = 1 and inside the M = 2 batch.
    x2, y2 = outs[2]
    assert torch.equal(quant_matmul(x2[:1].contiguous(), wd, ws).float(), y2[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,H", [(1, 64, 32), (2, 128, 24), (160, 128, 24)])
def test_flash_decode_kernel_matches_plain(card, S, D, H):
    """The kernel keeps the probabilities in f32 and rounds only its output
    to bf16, so it is held to the plain version on f32 copies of the same
    inputs, element by element: 2^-8 of |ref| (bf16 output rounding) plus
    2^-16 (f32 summation order). Values past the last position are 64, so a
    mask that lets a masked key in fails. A dead row (position -1) is
    exactly zero."""
    rng = np.random.default_rng(S + D)
    B, KVH, T = 2, 8, 256
    q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32))
    pos = torch.from_numpy((rng.integers(0, T - S, (B, 1)) + np.arange(S)).astype(np.int32))
    for b in range(B):
        v[b, :, int(pos[b, -1]) + 1:] = 64.0
    pos[1, 0] = -1
    q, k, v = (t.to(card).bfloat16() for t in (q, k, v))
    pos = pos.to(card)
    got = flash_decode(q, k, v, pos).float()
    ref = flash_decode_plain(q.float(), k.float(), v.float(), pos)
    assert torch.all((got - ref).abs() <= 2.0 ** -8 * ref.abs() + 2.0 ** -16)
    assert torch.all(got[1, 0] == 0)


@pytest.mark.cuda
def test_flash_decode_rejects_misaligned_view(card):
    """The kernel reads 16-byte vectors: a view that starts off that
    alignment raises in the wrapper instead of faulting on the card."""
    B, S, H, KVH, T, D = 1, 1, 24, 8, 256, 128
    q = torch.zeros((B, S, H, D), device=card, dtype=torch.bfloat16)
    k = torch.zeros((B * KVH * T * D + 1,), device=card, dtype=torch.bfloat16)
    k = k[1:].view(B, KVH, T, D)
    pos = torch.zeros((B, S), device=card, dtype=torch.int32)
    with pytest.raises(ValueError, match="aligned"):
        flash_decode(q, k, k, pos)


@pytest.mark.cuda
def test_verify_prefix_kernel_matches_plain_exactly(card):
    """A forced tie, a NaN in a matching row and an all-NaN row, read through
    the strided first-K-rows view of [B, K+1, V] logits."""
    rng = np.random.default_rng(0)
    B, K, V = 4, 4, 128256
    full = rng.normal(0, 1, (B, K + 1, V)).astype(np.float32)
    logits = full[:, :K]
    draft = np.argmax(logits, -1).astype(np.int32)
    draft[1, 2] = (draft[1, 2] + 1) % V
    logits[3, 1, 7] = logits[3, 1, 900] = logits[3, 1].max() + 1.0
    draft[3, 1] = 7
    logits[0, 3, 5] = np.nan
    logits[2, 0, :] = np.nan
    d = torch.from_numpy(draft).to(card)
    lg = torch.from_numpy(full).to(card)[:, :K]
    assert not lg.is_contiguous()
    got, ref = verify_prefix(d, lg), verify_prefix_plain(d, lg)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[0].tolist() == [3, 2, 0, 4]
