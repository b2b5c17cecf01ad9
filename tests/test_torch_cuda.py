"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips on a machine without a CUDA card:
a kernel has no CPU mode. The file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to the same versions at every shape of
the main path; these tests are the quick check at a few of them.
"""

import gc

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.specstep import DecodeLoop, make_decode_loop
from llm_inference_lab_tpu_torch.models.base import quantize_rows
from llm_inference_lab_tpu_torch.models.paged import gather_pages
from llm_inference_lab_tpu_torch.ops.attention import paged_attend
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_int8,
    flash_decode_plain,
    ticket_counters,
)
from llm_inference_lab_tpu_torch.ops import flash_decode as fd
from llm_inference_lab_tpu_torch.ops import kernel_wrappers
from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_int8
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_int8
from llm_inference_lab_tpu_torch.ops.quant import quantize_int4
from llm_inference_lab_tpu_torch.ops.rms_norm import add_rms_norm, rms_norm, rms_norm_plain
from llm_inference_lab_tpu_torch.ops.sampling import (
    proposal_log_probs,
    sample_tokens,
    seed_key,
    uniform,
)
from llm_inference_lab_tpu_torch.ops.quant_matmul import (
    MMA_MIN_M,
    quant_matmul,
    quant_matmul_int8,
    quant_matmul_int8_mma,
    quant_matmul_mma,
    quant_matmul_plain,
    quant_matmul_plain_int8,
)
from llm_inference_lab_tpu_torch.ops.verify import (
    split_width,
    verify_plan,
    verify_prefix,
    verify_prefix_plain,
    verify_prefix_split_plain,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(3072, 5120), (8192, 2048)])
def test_int4_kernel_matches_plain(card, K, N):
    """bf16 output: tolerance 1e-2 of the largest magnitude (bf16 rounding of
    the output, 2^-8 relative, plus f32 summation order). M = 160 takes the
    tensor-core path (its own launch count)."""
    rng = np.random.default_rng(K + N)
    w = quantize_int4(torch.from_numpy(rng.normal(0, 0.02, (K, N)).astype(np.float32)))
    wd, ws = w.data.to(card), w.scale.to(card)
    outs = {}
    for M in (1, 2, 160):
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32)).to(card).bfloat16()
        route = quant_matmul_mma if M >= MMA_MIN_M else quant_matmul
        before = route.launches
        got = quant_matmul(x, wd, ws).float()
        assert route.launches == before + 1
        ref = quant_matmul_plain(x, wd, ws).float()
        assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()
        outs[M] = (x, got)
    # Row 0 rounds identically at M = 1 and inside the M = 2 batch.
    x2, y2 = outs[2]
    assert torch.equal(quant_matmul(x2[:1].contiguous(), wd, ws).float(), y2[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,H", [(1, 64, 32), (2, 128, 24), (160, 128, 24)])
def test_flash_decode_kernel_matches_plain(card, S, D, H):
    """The kernel rounds p to bf16 before its P.V product (as Pallas does)
    and its output to bf16, so it is held to the plain version on f32
    copies of the same inputs by _attn_within. Values past the last position
    are 64, so a mask that lets a masked key in fails. A dead row (position
    -1) is exactly zero."""
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
    got = flash_decode(q, k, v, pos)
    assert _attn_within(got, q, k, v, pos)
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


def _f32_plain(q, k, v, pos, ks=None, vs=None, **opts):
    """The plain version on f32 copies (an int8 cache dequantized in f32),
    and the same with |v|: (ref, sum_j P_j |v_j|) per output element."""
    kf, vf = k.float(), v.float()
    if ks is not None:
        kf, vf = kf * ks[..., None], vf * vs[..., None]
    ref = flash_decode_plain(q.float(), kf, vf, pos, **opts)
    return ref, flash_decode_plain(q.float(), kf, vf.abs(), pos, **opts)


def _attn_within(got, q, k, v, pos, ks=None, vs=None, **opts):
    """Kernels D and E against their plain version on f32 copies. They round
    p (for int8 p times v's scale) to bf16 before P.V, as Pallas does: at
    most 2^-9 of sum_j P_j |v_j| an output; the bf16 output 2^-9 |ref|; f32
    order 2^-16. Held to 2^-8 |ref| + 2^-8 sum_j P_j |v_j| + 2^-16 (twice
    the p term), and finite."""
    ref, mag = _f32_plain(q, k, v, pos, ks, vs, **opts)
    got = got.float()
    return bool(torch.isfinite(got).all() and torch.all(
        (got - ref).abs() <= 2.0 ** -8 * ref.abs() + 2.0 ** -8 * mag + 2.0 ** -16))


def _attn_close(a, b, q, k, v, pos, ks=None, vs=None, **opts):
    """D and E on the same rows, each within its tolerance of the plain
    version, so within the sum of both of each other: 2^-7 |b| + 2^-8
    sum_j P_j |v_j| + 2^-15. (E walks a row's keys in one block, D splits
    them and combines, so the two need not share bits; F gives D's.)"""
    _, mag = _f32_plain(q, k, v, pos, ks, vs, **opts)
    a, b = a.float(), b.float()
    return bool(torch.all((a - b).abs() <= 2.0 ** -7 * b.abs() + 2.0 ** -8 * mag + 2.0 ** -15))


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,H", [(64, 64, 32), (160, 128, 24), (333, 128, 24), (97, 256, 16)])
def test_flash_prefill_kernel_matches_plain_and_rows_are_independent(card, S, D, H):
    """Sequence 0 prefills from 0, sequence 1 resumes at 128 with a dead
    first row; V past each last position is 64. Every row is within the
    tolerance, and bit-identical alone, inside its block, at T = 1024, at T
    cut just past the positions (not a multiple of 64) and in a chunk of
    the rows; flash_decode on a row is within both tolerances of it."""
    rng = np.random.default_rng(S + D)
    B, KVH, T = 2, 8, 1024
    q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32))
    pos = torch.from_numpy(np.stack([np.arange(S), 128 + np.arange(S)]).astype(np.int32))
    v[0, :, S:] = 64.0
    v[1, :, 128 + S:] = 64.0
    pos[1, 0] = -1
    q, k, v = (t.to(card).bfloat16() for t in (q, k, v))
    pos = pos.to(card)
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, pos)
    assert flash_prefill.launches == before + 1
    assert _attn_within(got, q, k, v, pos)
    assert torch.all(got[1, 0] == 0)
    T_cut = 128 + S + 3
    assert torch.equal(flash_prefill(q, k[:, :, :T_cut], v[:, :, :T_cut], pos), got)
    c0, c1 = S // 3, S // 3 + 40  # a chunk of the prompt: the same rows of the whole
    chunk = flash_prefill(q[:, c0:c1].contiguous(), k, v, pos[:, c0:c1].contiguous())
    assert torch.equal(chunk, got[:, c0:c1])
    for j in (1, S // 2, S - 1):
        qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
        assert torch.equal(flash_prefill(qj, k, v, pj), got[:, j:j + 1])
        assert _attn_close(flash_decode(qj, k, v, pj), got[:, j:j + 1], qj, k, v, pj)


def _paged(card, rng, B, S, H, KVH, D, P, N_extra=3):
    M = 1024 // P
    N = B * M + N_extra
    q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32)).to(card).bfloat16()
    pool = torch.from_numpy(rng.normal(0, 1, (2, N, KVH, P, D)).astype(np.float32))
    pool = pool.to(card).bfloat16()
    table = torch.from_numpy((rng.permutation(N - 1)[: B * M].reshape(B, M) + 1).astype(np.int32))
    last = rng.integers(S, 1000, (B,))
    pos = torch.from_numpy((last[:, None] - S + 1 + np.arange(S)[None]).astype(np.int32))
    return q, pool[0], pool[1], table.to(card), pos.to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,H,P", [(1, 64, 32, 16), (2, 128, 24, 64), (5, 128, 24, 32)])
def test_paged_flash_kernel_matches_plain_and_flash_decode_bits(card, S, D, H, P):
    """B=8 sequences at positions up to 1000 through shuffled tables, one
    dead row: within _attn_within of the plain version (F runs D's body and
    rounds p to bf16), and flash_decode over the gathered contiguous keys
    gives the same bits."""
    rng = np.random.default_rng(10 * S + P)
    q, kp, vp, table, pos = _paged(card, rng, 8, S, H, 8, D, P)
    pos[1, 0] = -1
    before = paged_flash.launches
    got = paged_flash(q, kp, vp, pos, table)
    assert paged_flash.launches == before + 1
    kc, vc = gather_pages(kp, table), gather_pages(vp, table)
    assert _attn_within(got, q, kc, vc, pos)
    assert torch.all(got[1, 0] == 0)
    assert torch.equal(flash_decode(q, kc, vc, pos), got)


@pytest.mark.cuda
def test_paged_flash_rejects_misaligned_pool_and_foreign_table(card):
    rng = np.random.default_rng(0)
    q, kp, vp, table, pos = _paged(card, rng, 2, 1, 24, 8, 128, 64)
    flat = torch.zeros((kp.numel() + 1,), device=card, dtype=torch.bfloat16)
    misaligned = flat[1:].view(kp.shape)
    with pytest.raises(ValueError, match="aligned"):
        paged_flash(q, misaligned, misaligned, pos, table)
    with pytest.raises(ValueError, match="device"):
        paged_flash(q, kp, vp, pos, table.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(3072, 5120), (8192, 2048)])
def test_int8_kernel_matches_plain_and_rows_ignore_m(card, K, N):
    """Kernel B on random int8 bytes (-128 included) against the plain
    version on the same inputs in f32, per element: 2^-8 |ref| (bf16
    output rounding) + 2^-14 of the largest output (f32 sums in another
    order over K terms). The first M rows of one x: every row has the same
    bits at M = 1, 5 and 40."""
    g = torch.Generator(device=card).manual_seed(K + N)
    w = torch.randint(-128, 128, (2, K, N), generator=g, dtype=torch.int8, device=card)[1]
    scale = torch.rand((N,), generator=g, device=card) * (0.02 / 127) + 1e-5
    x = torch.randn((40, K), generator=g, device=card).bfloat16()
    outs = {}
    for M in (1, 5, 40):
        before = quant_matmul_int8.launches
        got = quant_matmul_int8(x[:M], w, scale)
        assert quant_matmul_int8.launches == before + 1
        ref = quant_matmul_plain_int8(x[:M].float(), w, scale)
        tol = 2.0 ** -8 * ref.abs() + 2.0 ** -14 * ref.abs().max()
        assert torch.all((got.float() - ref).abs() <= tol)
        outs[M] = got
    assert torch.equal(outs[5][:1], outs[1]) and torch.equal(outs[40][:5], outs[5])


@pytest.mark.cuda
def test_int8_kernel_rejects_misaligned_and_strided_weights(card):
    K, N = 2048, 2048
    x = torch.zeros((1, K), device=card, dtype=torch.bfloat16)
    scale = torch.ones((N,), device=card)
    flat = torch.zeros((K * N + 8,), device=card, dtype=torch.int8)
    with pytest.raises(ValueError, match="aligned"):
        quant_matmul_int8(x, flat[8 - 1:-1].view(K, N), scale)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul_int8(x, flat[:K * N].view(N, K).t(), scale)
    with pytest.raises(ValueError, match="N % 64"):
        quant_matmul_int8(x, flat[:K * 96].view(K, 96), scale[:96])


def _int8_cache(card, g, shape):
    """N(0, 1) rows quantized per row on the card: (int8, f32 scales)."""
    return quantize_rows(torch.randn(shape, generator=g, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,H", [(1, 64, 32), (5, 128, 24), (160, 128, 24)])
def test_int8_attention_kernels_match_plain_and_each_other(card, S, D, H):
    """D-, E- and F-int8 over one int8 cache: sequence 0 ends at 180,
    sequence 1 at 250 with a dead first row; keys past each last position
    hold bytes 127 with a scale of 0.5 (a masked key let in moves an output
    by far more than the tolerance). D and E within _attn_within of the
    plain version on f32 q (which dequantizes the cache to f32); E alone on
    a row equals the row in its block, D on a row is within both tolerances
    of E; F over the same keys in shuffled 64-row pages gives D's bits."""
    g = torch.Generator(device=card).manual_seed(S + D)
    B, KVH, T, P = 2, 8, 256, 64
    q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
    k, ks = _int8_cache(card, g, (B, KVH, T, D))
    v, vs = _int8_cache(card, g, (B, KVH, T, D))
    last = [180, 250]
    for b in range(B):
        for t, st in ((k, ks), (v, vs)):
            t[b, :, last[b] + 1:] = 127
            st[b, :, last[b] + 1:] = 0.5
    pos = torch.tensor(last, device=card, dtype=torch.int32)[:, None] - S + 1
    pos = (pos + torch.arange(S, device=card, dtype=torch.int32)[None]).contiguous()
    pos[1, 0] = -1
    route = flash_decode_int8 if S <= 32 else flash_prefill_int8
    before = route.launches
    got = route(q, k, v, pos, ks, vs)
    assert route.launches == before + 1
    assert _attn_within(got, q, k, v, pos, ks, vs) and torch.all(got[1, 0] == 0)
    if S > 32:
        for j in (1, S // 2, S - 1):
            qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
            assert torch.equal(flash_prefill_int8(qj, k, v, pj, ks, vs), got[:, j:j + 1])
            assert _attn_close(flash_decode_int8(qj, k, v, pj, ks, vs), got[:, j:j + 1], qj, k,
                               v, pj, ks, vs)
        return
    M = T // P
    table = (torch.randperm(B * M + 2, generator=g, device=card)[: B * M] + 1).view(B, M)
    table = table.to(torch.int32).contiguous()
    N = B * M + 3

    def pool(src, tail):
        dst = torch.zeros((N, KVH, P, *tail), device=card, dtype=src.dtype)
        dst[table.flatten().long()] = (src.reshape(B, KVH, M, P, *tail).transpose(1, 2)
                                       .reshape(B * M, KVH, P, *tail))
        return dst

    kp, vp, ksp, vsp = pool(k, (D,)), pool(v, (D,)), pool(ks, ()), pool(vs, ())
    assert torch.equal(gather_pages(ksp, table), ks)
    before = paged_flash_int8.launches
    paged = paged_flash_int8(q, kp, vp, pos, table, ksp, vsp)
    assert paged_flash_int8.launches == before + 1
    assert torch.equal(got, paged)


def _gemma2_keys(card, g, cache, B, KVH, T, D, pos, window):
    """K, V [B, KVH, T, D] (bf16, or int8 with f32 scales) of N(0, 1) rows,
    with POISON (64 in every element of K and V; int8 bytes 127 at a scale
    of 0.5) at the keys no live row of a sequence sees: past its largest
    position and, with a window, at or below its smallest position minus
    the window. A masked key let in dominates its row's softmax."""
    k = torch.randn((B, KVH, T, D), generator=g, device=card)
    v = torch.randn((B, KVH, T, D), generator=g, device=card)
    dead = torch.zeros((B, T), dtype=torch.bool, device=card)
    for b in range(B):
        live = pos[b][pos[b] >= 0]
        dead[b, int(live.max()) + 1:] = True
        if window:
            dead[b, : max(int(live.min()) - window + 1, 0)] = True
    if cache == "int8":
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        for t, st in ((k, ks), (v, vs)):
            t[dead[:, None].expand(B, KVH, T)] = 127
            st[dead[:, None].expand(B, KVH, T)] = 0.5
        return k, v, ks, vs
    k[dead[:, None].expand(B, KVH, T)] = 64.0
    v[dead[:, None].expand(B, KVH, T)] = 64.0
    return k.bfloat16(), v.bfloat16(), None, None


@pytest.mark.cuda
@pytest.mark.parametrize("window", [256, None])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("H,KVH", [(16, 8), (8, 4)])
def test_gemma2_attention_kernels_match_plain_and_each_other(card, H, KVH, cache, window):
    """Kernels D, E and F at head dim 256 with Gemma-2's options (scale
    1/16, softcap 50) and a window of 256 (a local layer) or none (a global
    one) over T = 1024, POISON at every key a sequence's rows do not see.
    Decode rows at 299..300 and 999..1000, one dead; prefill rows at
    200..263 (crossing the window) and 900..963. D and E within
    _attn_within of the plain version on f32 q, all finite; E on the decode
    rows and D on single prefill rows each within both tolerances of the
    other kernel; F through shuffled 64-row pages with D's bits."""
    g = torch.Generator(device=card).manual_seed(H + (window or 0))
    B, T, D, P = 2, 1024, 256, 64
    opts = dict(scale=1 / 16, softcap=50.0, window=window)
    route = {"bf16": (flash_decode, flash_prefill, paged_flash),
             "int8": (flash_decode_int8, flash_prefill_int8, paged_flash_int8)}[cache]
    for S, last in ((2, (300, 1000)), (64, (263, 963))):
        pos = (torch.tensor(last, device=card, dtype=torch.int32)[:, None] - S + 1
               + torch.arange(S, device=card, dtype=torch.int32)[None]).contiguous()
        if S == 2:
            pos[1, 0] = -1
        k, v, ks, vs = _gemma2_keys(card, g, cache, B, KVH, T, D, pos, window)
        q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
        scales = (ks, vs) if cache == "int8" else ()
        kernel = route[0] if S <= 32 else route[1]
        before = kernel.launches
        got = kernel(q, k, v, pos, *scales, **opts)
        assert kernel.launches == before + 1
        assert _attn_within(got, q, k, v, pos, *scales, **opts)
        if S == 2:
            assert torch.all(got[1, 0] == 0)
            assert _attn_close(route[1](q, k, v, pos, *scales, **opts), got, q, k, v, pos,
                               *scales, **opts)
            M = T // P
            table = (torch.randperm(B * M + 2, generator=g, device=card)[: B * M] + 1)
            table = table.view(B, M).to(torch.int32).contiguous()

            def pool(src):
                tail = src.shape[3:]
                dst = torch.zeros((B * M + 3, KVH, P, *tail), device=card, dtype=src.dtype)
                dst[table.flatten().long()] = (src.reshape(B, KVH, M, P, *tail).transpose(1, 2)
                                               .reshape(B * M, KVH, P, *tail))
                return dst

            paged = route[2](q, pool(k), pool(v), pos, table, *(pool(s) for s in scales), **opts)
            assert torch.equal(got, paged)
        else:
            for j in (0, 55, 56, 63):  # 56: the first row whose window cuts key 0
                qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                assert torch.equal(route[1](qj, k, v, pj, *scales, **opts), got[:, j:j + 1])
                assert _attn_close(route[0](qj, k, v, pj, *scales, **opts), got[:, j:j + 1], qj,
                                   k, v, pj, *scales, **opts)


def _ring_keys(card, g, cache, B, KVH, D, R, T, W, pos, Tf):
    """The same keys two ways: a full cache [B, KVH, Tf, D] indexed by
    position, with POISON (as _gemma2_keys) at the positions no live row of
    a sequence sees (below its smallest position minus W, past its largest
    one); and a ring [B, KVH, T, D] of R slots, whose slot s holds the latest
    position at most the sequence's largest one that is congruent to s mod R
    (POISON where there is none), as the engine's ring writes leave it.
    Returns (full, ring), each (k, v, k_scale, v_scale)."""
    # Position Tf (past every live row) is POISON: the slots no position fills.
    full = _gemma2_keys(card, g, cache, B, KVH, Tf + 1, D, pos, W)
    slots = torch.arange(T, device=card)
    idx = torch.stack([int(p[p >= 0].max()) - (int(p[p >= 0].max()) - slots) % R for p in pos])
    idx = torch.where(idx >= 0, idx, Tf)  # [B, T]
    ring = [None if t is None else torch.stack(
        [t[b][:, idx[b]] for b in range(B)]).contiguous() for t in full]
    return [None if t is None else t[:, :, :Tf].contiguous() for t in full], ring


@pytest.mark.cuda
@pytest.mark.parametrize("T", [512, 256])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_ring_attention_kernels_match_plain_and_full_cache(card, cache, T):
    """Kernels D and E with ring_len R = 512 and window 200 at Mistral's
    geometry (32 / 8 heads of 128), on a ring of T = R slots and on one of
    T = 256 < R (positions whose slot is T or more do not exist there).
    Decode rows (S = 5) at 1200..1204 (the window wraps the ring), 100..104
    and, at T = 256, 496..500 (every slot the window reaches is past T:
    zeros, not NaN); a dead row. Prefill rows (S = 64) at 1000..1063
    (crossing the wrap at 1024) and 0..63. POISON at every position and slot
    no live row sees. Each kernel within 2^-8 |ref| + 2^-16 of its plain
    version (_attn_within), finite; E and D within both tolerances of each
    other, a row alone equal to the row among others (D at S = 1 and S = 5,
    E alone and in its chunk); at T = R both equal their own results over a
    full cache of the same keys by position (the body walks positions, so
    the ring's wrap costs no bits). A ring shorter than a 64-key tile is
    refused."""
    g = torch.Generator(device=card).manual_seed(T)
    H, KVH, D, R, W, Tf = 32, 8, 128, 512, 200, 1280
    opts = dict(window=W, ring_len=R)
    route = {"bf16": (flash_decode, flash_prefill), "int8": (flash_decode_int8,
                                                             flash_prefill_int8)}[cache]
    lasts = {5: (1204, 104, 500) if T < R else (1204, 104), 64: (1063, 63)}
    for S, last in lasts.items():
        B = len(last)
        pos = (torch.tensor(last, device=card, dtype=torch.int32)[:, None] - S + 1
               + torch.arange(S, device=card, dtype=torch.int32)[None]).contiguous()
        pos[1, 0] = -1
        full, ring = _ring_keys(card, g, cache, B, KVH, D, R, T, W, pos, Tf)
        q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
        k, v, *scales = ring
        scales = [s for s in scales if s is not None]
        kernel = route[0] if S <= 32 else route[1]
        before = kernel.launches
        got = kernel(q, k, v, pos, *scales, **opts)
        assert kernel.launches == before + 1
        assert _attn_within(got, q, k, v, pos, *scales, **opts)
        assert torch.all(got[1, 0] == 0)
        if B == 3:
            assert torch.all(got[2] == 0)  # no slot of its window is in the plane
        if S <= 32:
            assert _attn_close(route[1](q, k, v, pos, *scales, **opts), got, q, k, v, pos,
                               *scales, **opts)
            one = route[0](q[:, -1:].contiguous(), k, v, pos[:, -1:].contiguous(), *scales, **opts)
            assert torch.equal(one, got[:, -1:])  # S = 1 against row S - 1 of S = 5
        else:
            for j in (0, 23, 24, 63):  # row 24 of sequence 0 is at the wrap, 1024
                qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                assert torch.equal(route[1](qj, k, v, pj, *scales, **opts), got[:, j:j + 1])
                assert _attn_close(route[0](qj, k, v, pj, *scales, **opts), got[:, j:j + 1], qj,
                                   k, v, pj, *scales, **opts)
        if T == R:
            fk, fv, *fs = full
            fs = [s for s in fs if s is not None]
            assert torch.equal(kernel(q, fk, fv, pos, *fs, window=W), got)
    with pytest.raises(ValueError, match="ring_len"):  # shorter than a tile of keys
        kernel(q, k, v, pos, *scales, window=16, ring_len=16)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("T,window,p_last", [(256, None, 167), (4480, 4096, 4352)])
def test_flash_decode_splits_match_plain_and_repeat(card, cache, T, window, p_last):
    """Kernel D over one split (T = 256) and over 17 (T = 4480, window 4096,
    rows at 4348..4352: keys 257..4352 in splits 1..17 of 256), Mistral's
    geometry: within _attn_within of the plain version; the S = 1 call on
    the last position equals that row of the S = 5 verify bit for bit;
    repeated calls give the same bits (the combine takes the splits in a
    fixed order, whichever block finishes last); one launch a call."""
    g = torch.Generator(device=card).manual_seed(T + (window or 0))
    B, H, KVH, D, S = 2, 32, 8, 128, 5
    q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
    pos = (p_last - S + 1 + torch.arange(S, device=card, dtype=torch.int32))[None].repeat(B, 1)
    pos = pos.contiguous()
    pos[1, 0] = -1
    if cache == "int8":
        (k, ks), (v, vs) = (_int8_cache(card, g, (B, KVH, T, D)) for _ in "kv")
        scales, kernel = (ks, vs), flash_decode_int8
    else:
        k, v = (torch.randn((B, KVH, T, D), generator=g, device=card).bfloat16() for _ in "kv")
        scales, kernel = (), flash_decode
    opts = {} if window is None else {"window": window}
    before = kernel.launches
    got = kernel(q, k, v, pos, *scales, **opts)
    assert kernel.launches == before + 1
    assert _attn_within(got, q, k, v, pos, *scales, **opts)
    assert torch.all(got[1, 0] == 0)
    one = kernel(q[:, -1:].contiguous(), k, v, pos[:, -1:].contiguous(), *scales, **opts)
    assert torch.equal(one, got[:, -1:])
    for _ in range(3):
        assert torch.equal(kernel(q, k, v, pos, *scales, **opts), got)


@pytest.mark.cuda
@pytest.mark.parametrize("N,one_offset,w_dtype", [(3072, False, torch.bfloat16),
                                                  (3584, True, torch.bfloat16),
                                                  (4096, False, torch.float32)])
def test_rms_norm_kernel_matches_plain_and_rows_ignore_m(card, N, one_offset, w_dtype):
    """The rms_norm kernel within one bf16 step of each output of the plain
    formula (the mean summed in another order can move the last rounding),
    and every row with the same bits alone and among M = 2, 5, 8, 16, 40
    rows; one launch a call."""
    g = torch.Generator(device=card).manual_seed(N)
    x = (torch.randn((40, N), generator=g, device=card) * 3).bfloat16()
    w = (torch.randn((N,), generator=g, device=card) * 0.1 + (0 if one_offset else 1)).to(w_dtype)
    before = rms_norm.launches
    got = rms_norm(x, w, 1e-6, one_offset)
    assert rms_norm.launches == before + 1
    ref = rms_norm_plain(x, w, 1e-6, one_offset).float()
    step = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert torch.all((got.float() - ref).abs() <= step)
    alone = torch.cat([rms_norm(x[i:i + 1], w, 1e-6, one_offset) for i in range(40)])
    for M in (2, 5, 8, 16, 40):
        assert torch.equal(rms_norm(x[:M], w, 1e-6, one_offset), alone[:M]), M


def _pool_of(card, g, src, P, extra=2):
    """The same keys (or scales) [B, KVH, T(, D)] in shuffled P-row pages
    [B * M + extra + 1, KVH, P(, D)] through a table [B, M + extra] whose
    last entries point at pages no row reads (page 0 unused)."""
    B, KVH, T = src.shape[:3]
    M = T // P
    ids = torch.randperm(B * (M + extra), generator=g, device=card) + 1
    table = ids.view(B, M + extra).to(torch.int32).contiguous()
    tail = src.shape[3:]
    dst = torch.randn((B * (M + extra) + 1, KVH, P, *tail), generator=g, device=card).to(src.dtype)
    dst[table[:, :M].flatten().long()] = (src.reshape(B, KVH, M, P, *tail).transpose(1, 2)
                                          .reshape(B * M, KVH, P, *tail))
    return dst, table


OPTION_SETS = [{}, {"scale": 0.11, "softcap": 20.0}, {"window": 300},
               {"scale": 1 / 16, "softcap": 50.0, "window": 97}]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [16, 64, 128])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_paged_flash_equals_flash_decode_bits(card, cache, D, P):
    """Kernel F gives kernel D's bits on the same keys: four sequences at
    positions up to 1000 (one dead row, one sequence at 20), T = 1024 in
    the contiguous cache and two more table entries than the keys need (so
    F's split count, from M * P, may exceed D's), at S = 1 and 5, with every
    option set: none, scale and softcap, a window, all three. Each F call
    is one launch and within _attn_within of the plain version."""
    g = torch.Generator(device=card).manual_seed(D + P)
    H, KVH = {64: (32, 8), 96: (32, 32), 128: (24, 8), 256: (16, 8)}[D]
    B, T = 4, 1024
    if cache == "int8":
        (k, ks), (v, vs) = (_int8_cache(card, g, (B, KVH, T, D)) for _ in "kv")
        scales, dk, fk = (ks, vs), flash_decode_int8, paged_flash_int8
    else:
        k, v = (torch.randn((B, KVH, T, D), generator=g, device=card).bfloat16() for _ in "kv")
        scales, dk, fk = (), flash_decode, paged_flash
    pools = []
    for t in (k, v, *scales):
        g_t = torch.Generator(device=card).manual_seed(D + P)  # one table for all four
        pool, table = _pool_of(card, g_t, t, P)
        pools.append(pool)
    for S in (1, 5):
        last = torch.tensor([1000, 611, 20 + S, 333], device=card, dtype=torch.int32)
        pos = (last[:, None] - S + 1 + torch.arange(S, device=card, dtype=torch.int32)[None])
        pos = pos.contiguous()
        pos[3, 0] = -1
        q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
        for opts in OPTION_SETS:
            ref = dk(q, k, v, pos, *scales, **opts)
            before = fk.launches
            got = fk(q, pools[0], pools[1], pos, table, *pools[2:], **opts)
            assert fk.launches == before + 1
            assert torch.equal(got, ref), (S, opts)
            assert _attn_within(got, q, k, v, pos, *scales, **opts), (S, opts)


@pytest.mark.cuda
def test_paged_flash_rejects_page_size_not_a_power_of_two(card):
    rng = np.random.default_rng(1)
    q, kp, vp, table, pos = _paged(card, rng, 2, 1, 24, 8, 128, 64)
    with pytest.raises(ValueError, match="power of two"):
        paged_flash(q, kp[:, :, :48], vp[:, :, :48], pos, table)


QMM_SHAPES = [(3072, 5120), (8192, 2048), (2048, 2048)]  # 3B qkv, 1B down and o
QMM_MMA_M = (64, 160, 512, 2048)
QMM_DECODE_M = (1, 2, 5, 8, 16, 40, 63)


def _qmm_inputs(card, bits, K, N, M):
    g = torch.Generator(device=card).manual_seed(K + N + bits)
    rows = K // 2 if bits == 4 else K
    w = torch.randint(-128, 128, (2, rows, N), generator=g, dtype=torch.int8, device=card)[1]
    scale = torch.rand((N,), generator=g, device=card) * (0.02 / (7 if bits == 4 else 127)) + 1e-5
    x = torch.randn((M, K), generator=g, device=card).bfloat16()
    return x, w, scale


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QMM_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_tensor_core_path_matches_plain_and_rows_ignore_m(card, bits, K, N):
    """Kernels A and B at M = 64, 160, 512 and 2048 (the first M rows of one
    x, random bytes, -128 included) take the tensor-core path, one launch of
    its own a call: within the tolerance of the plain version on the same
    inputs in f32 (A: 1e-2 of the largest output, test_int4_kernel_matches_
    plain's; B: 2^-8 |ref| + 2^-14 of the largest, test_int8_kernel_matches_
    plain_and_rows_ignore_m's), and every row with the same bits at every
    M; a repeated call gives the same bits."""
    x, w, scale = _qmm_inputs(card, bits, K, N, max(QMM_MMA_M))
    kernel, mma, plain = ((quant_matmul, quant_matmul_mma, quant_matmul_plain) if bits == 4 else
                          (quant_matmul_int8, quant_matmul_int8_mma, quant_matmul_plain_int8))
    outs = {}
    for M in QMM_MMA_M:
        before, before_split = mma.launches, kernel.launches
        got = kernel(x[:M], w, scale)
        assert mma.launches == before + 1 and kernel.launches == before_split
        ref = plain(x[:M].float(), w, scale)
        err = (got.float() - ref).abs()
        if bits == 4:
            assert err.max() <= 1e-2 * ref.abs().max(), (M, err.max())
        else:
            assert torch.all(err <= 2.0 ** -8 * ref.abs() + 2.0 ** -14 * ref.abs().max()), M
        outs[M] = got
    for M in QMM_MMA_M[:-1]:
        assert torch.equal(outs[M], outs[max(QMM_MMA_M)][:M]), M
    assert torch.equal(kernel(x[:160], w, scale), outs[160])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_decode_shapes_take_the_decode_body(card, bits):
    """M = 1, 2, 5, 8, 16, 40 and 63 launch the decode body (csrc/
    qmm_decode.cuh), one launch a call on its own count (the tensor-core
    path's count stays), every row with the same bits at each of them."""
    K, N = 3072, 5120
    x, w, scale = _qmm_inputs(card, bits, K, N, 63)
    kernel, mma = ((quant_matmul, quant_matmul_mma) if bits == 4 else
                   (quant_matmul_int8, quant_matmul_int8_mma))
    before, before_mma = kernel.launches, mma.launches
    outs = {M: kernel(x[:M], w, scale) for M in QMM_DECODE_M}
    assert kernel.launches == before + len(QMM_DECODE_M) and mma.launches == before_mma
    for M in QMM_DECODE_M:
        assert torch.equal(outs[M], outs[MMA_MIN_M - 1][:M]), M


# (K, N) of every projection the decode paths run: the 3B and 1B, Gemma-2
# 9B and 2B, Mistral-7B and its untied head (N = 32000 = 125 x 256).
QMM_DECODE_WIDTHS = {
    "3B": [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072)],
    "1B": [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)],
    "Gemma-2 9B": [(3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584)],
    "Gemma-2 2B": [(2304, 4096), (2048, 2304), (2304, 18432), (9216, 2304)],
    "Mistral-7B": [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(QMM_DECODE_WIDTHS))
@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_decode_matches_plain_and_rows_ignore_m(card, bits, width):
    """The decode body at every projection of a width, at M = 1, 2, 5, 8, 16,
    40 and 63 (the first M rows of one x, random bytes, -128 included):
    within the tolerance of the plain version on the same inputs in f32 (A:
    1e-2 of the largest output; B: 2^-8 |ref| + 2^-14 of the largest, as
    test_qmm_tensor_core_path_matches_plain_and_rows_ignore_m), every row
    with the same bits as the row computed alone (M = 1), and two calls
    back to back on the same weights with the same bits (the split's ticket
    counters are zero again after each launch)."""
    kernel, plain = ((quant_matmul, quant_matmul_plain) if bits == 4 else
                     (quant_matmul_int8, quant_matmul_plain_int8))
    for K, N in QMM_DECODE_WIDTHS[width]:
        x, w, scale = _qmm_inputs(card, bits, K, N, max(QMM_DECODE_M))
        alone = torch.cat([kernel(x[i:i + 1], w, scale) for i in range(max(QMM_DECODE_M))])
        for M in QMM_DECODE_M:
            before = kernel.launches
            got = kernel(x[:M], w, scale)
            assert kernel.launches == before + 1
            ref = plain(x[:M].float(), w, scale)
            err = (got.float() - ref).abs()
            if bits == 4:
                assert err.max() <= 1e-2 * ref.abs().max(), (K, N, M, err.max())
            else:
                assert torch.all(err <= 2.0 ** -8 * ref.abs() + 2.0 ** -14 * ref.abs().max()), \
                    (K, N, M)
            assert torch.equal(got, alone[:M]), (K, N, M)
        assert torch.equal(kernel(x[:40], w, scale), kernel(x[:40], w, scale)), (K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_decode_rejects_what_it_does_not_take(card, bits):
    """Misaligned or strided x or w, a wrong dtype, and N not a multiple of
    256 raise before any launch."""
    K, N = 2048, 2048
    kernel = quant_matmul if bits == 4 else quant_matmul_int8
    rows = K // 2 if bits == 4 else K
    x = torch.zeros((4 * K + 8,), device=card, dtype=torch.bfloat16)
    w = torch.zeros((rows * N + 16,), device=card, dtype=torch.int8)
    scale = torch.ones((N,), device=card)
    before = kernel.launches
    with pytest.raises(ValueError, match="aligned"):
        kernel(x[1:2 * K + 1].view(2, K), w[:rows * N].view(rows, N), scale)
    with pytest.raises(ValueError, match="aligned"):
        kernel(x[:2 * K].view(2, K), w[1:rows * N + 1].view(rows, N), scale)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x[:4 * K].view(2, 2 * K)[:, :K], w[:rows * N].view(rows, N), scale)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x[:2 * K].view(2, K), w[:rows * N].view(N, rows).t(), scale)
    with pytest.raises(TypeError):
        kernel(x[:2 * K].view(2, K), w[:rows * N].view(rows, N), scale.double())
    with pytest.raises(TypeError):
        kernel(x[:2 * K].view(2, K).half(), w[:rows * N].view(rows, N), scale)
    with pytest.raises(ValueError, match="N % 64"):
        kernel(x[:2 * K].view(2, K), w[:rows * 96].view(rows, 96), scale[:96])
    assert kernel.launches == before


@pytest.mark.cuda
def test_qmm_tensor_core_path_rejects_what_it_does_not_take(card):
    K, N = 2048, 2048
    x = torch.zeros((64 * K + 8,), device=card, dtype=torch.bfloat16)
    w = torch.zeros((K // 2, N), device=card, dtype=torch.int8)
    scale = torch.ones((N,), device=card)
    with pytest.raises(ValueError, match="aligned"):
        quant_matmul_mma(x[1:64 * K + 1].view(64, K), w, scale)
    with pytest.raises(ValueError, match="N % 64"):
        quant_matmul_mma(x[:64 * K].view(64, K), w[:, :96].contiguous(), scale[:96])
    with pytest.raises(TypeError):
        quant_matmul_int8_mma(x[:64 * K].view(64, K).float(), w, scale)


NORM_WIDTHS = (2048, 2304, 3072, 3584, 4096)  # d_model of every model on the paths
NORM_ROWS = (1, 2, 5, 8, 16, 40, 63, 512, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "one_offset", "post_w"])
@pytest.mark.parametrize("N", NORM_WIDTHS)
def test_add_rms_norm_kernel_is_torch_add_then_rms_norm_bits(card, N, variant):
    """The fused kernel's two outputs have the bits of the unfused pair:
    torch's bf16 x + a' (a' = the rms_norm kernel on a with post_w, Gemma-2's
    sandwich norm, one-offset weights) and the rms_norm kernel on that sum,
    at every M of the paths, bf16 and f32 weights; one launch a call, the
    inputs untouched."""
    g = torch.Generator(device=card).manual_seed(N)
    one_offset = variant != "plain"
    x = (torch.randn((max(NORM_ROWS), N), generator=g, device=card) * 3).bfloat16()
    a = (torch.randn((max(NORM_ROWS), N), generator=g, device=card) * 2).bfloat16()
    x0, a0 = x.clone(), a.clone()
    for w_dtype in (torch.bfloat16, torch.float32):
        w = (torch.randn((N,), generator=g, device=card) * 0.1 + (0 if one_offset else 1))
        pw = (torch.randn((N,), generator=g, device=card) * 0.3).to(w_dtype)
        w = w.to(w_dtype)
        post = pw if variant == "post_w" else None
        for M in NORM_ROWS:
            before = add_rms_norm.launches, rms_norm.launches
            res, norm = add_rms_norm(x[:M], a[:M], w, 1e-6, one_offset, post)
            assert (add_rms_norm.launches, rms_norm.launches) == (before[0] + 1, before[1])
            a2 = a[:M] if post is None else rms_norm(a[:M], post, 1e-6, one_offset)
            ref = x[:M] + a2
            assert torch.equal(res, ref), (w_dtype, M, "residual")
            assert torch.equal(norm, rms_norm(ref, w, 1e-6, one_offset)), (w_dtype, M, "norm")
    torch.cuda.synchronize()
    assert torch.equal(x, x0) and torch.equal(a, a0)


@pytest.mark.cuda
def test_add_rms_norm_rejects_what_it_does_not_take(card):
    x = torch.zeros((2, 1024), device=card, dtype=torch.bfloat16)
    w = torch.ones(1024, device=card, dtype=torch.bfloat16)
    big = torch.zeros((2, 8200), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        add_rms_norm(big, big, torch.ones(8200, device=card, dtype=torch.bfloat16), 1e-6)
    with pytest.raises(ValueError):
        add_rms_norm(x, x[:1], w, 1e-6)
    with pytest.raises(TypeError):
        add_rms_norm(x, x, w, 1e-6, post_w=w.float())
    with pytest.raises(TypeError):
        add_rms_norm(x.float(), x.float(), w, 1e-6)
    flat = torch.zeros(2 * 1024 + 8, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # rows 2 bytes past a 16-byte boundary
        add_rms_norm(flat[1:2049].view(2, 1024), x, w, 1e-6)


def _verify_case(name, card):
    """(draft, logits) on the card for one of kernel C's cases: the main
    path's [1, 1, V] view of [1, 2, V]; [8, 4, V] as the first K rows of
    [8, 5, V]; V = 50257 rows 4 bytes past 16-byte boundaries; a tie across
    a split boundary; a NaN only in the last split; the special rows (a
    tie, a NaN in a matching row, an all-NaN row, an all -inf row)."""
    rng = np.random.default_rng(len(name))
    B, K, V = {"main 128256": (1, 1, 128256), "main 256000": (1, 1, 256000),
               "main 32000": (1, 1, 32000), "strided [8,4,V]": (8, 4, 128256),
               "unaligned 50257": (2, 3, 50257), "tie across a split boundary": (2, 2, 128256),
               "NaN in the last split only": (2, 2, 32000), "special rows": (4, 4, 50257)}[name]
    if name == "unaligned 50257":
        flat = torch.from_numpy(rng.normal(0, 1, B * K * V + 1).astype(np.float32)).to(card)
        lg = flat[1:].view(B, K, V)
    else:
        full = torch.from_numpy(rng.normal(0, 1, (B, K + 1, V)).astype(np.float32)).to(card)
        lg = full[:, :K]
    draft = torch.argmax(lg, -1).to(torch.int32)
    n = verify_plan(B * K, V)
    w = split_width(V, n)
    top = float(lg.max()) + 1.0
    if name == "tie across a split boundary":
        lg[0, 0, w - 1] = lg[0, 0, w] = top
        lg[1, 1, 3 * w] = lg[1, 1, w + 5] = top
        lg[0, 1, 2 * w] = lg[0, 1, 2 * w - 1] = top
        draft[0, 0], draft[1, 1], draft[0, 1] = w - 1, w + 5, 2 * w
    if name == "NaN in the last split only":
        lg[0, 0, V - 1] = lg[1, 1, (n - 1) * w] = float("nan")
    if name == "special rows":
        draft[1, 2] = (draft[1, 2] + 1) % V
        lg[3, 1, 7] = lg[3, 1, 9000] = top
        draft[3, 1] = 7
        lg[0, 3, 5] = float("nan")
        lg[2, 0, :] = float("nan")
        lg[3, 3, :] = float("-inf")
        draft[3, 3] = 0
    return draft, lg


VERIFY_CASES = ["main 128256", "main 256000", "main 32000", "strided [8,4,V]", "unaligned 50257",
                "tie across a split boundary", "NaN in the last split only", "special rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", VERIFY_CASES)
def test_verify_prefix_split_kernel_equals_plain(card, name):
    """Kernel C split over V: exactly the plain version and its own split
    plain version, one launch a call, the sequences' ticket counters back
    at 0 after each call, the same result when called again."""
    draft, lg = _verify_case(name, card)
    B, K, V = lg.shape
    ref = verify_prefix_plain(draft, lg)
    split = verify_prefix_split_plain(draft, lg, verify_plan(B * K, V))
    assert torch.equal(split[0], ref[0]) and torch.equal(split[1], ref[1])
    for _ in range(3):
        before = verify_prefix.launches
        got = verify_prefix(draft, lg)
        assert verify_prefix.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (got, ref)
        assert not ticket_counters(card, B)[:B].any()
    if name == "special rows":
        assert got[0].tolist() == [3, 2, 0, 4]
    if name == "tie across a split boundary":
        assert got[1].tolist() == [[True, False], [True, True]]


# ------------------------------------------------- the decode loop's graph
# llama-3.2-1b, int4 from a seed, as target and draft: every kernel of the
# decode path at widths it takes, in seconds.
GRAPH_CFG = dict(base_model="llama-3.2-1b", draft_model="llama-3.2-1b", max_new_tokens=16,
                 max_seq_len=256, quantization="int4", quantized_init=True, seed=0)
GRAPH_CASES = {
    "spec K=1": dict(max_draft=1),
    "spec K=4 int8 KV": dict(max_draft=4, kv_quantization="int8"),
    "baseline paged": dict(draft_model=None, kv_layout="paged", kv_page_size=64),
    "spec K=2 paged int8 KV": dict(max_draft=2, kv_layout="paged", kv_page_size=64,
                                   kv_quantization="int8"),
    # Mistral-7B's window of 4096: a ring of 4736 slots at max_seq_len 8192.
    "ring baseline": dict(base_model="mistral-7b", draft_model=None, max_seq_len=8192,
                          prefill_chunk=512, kv_ring=True),
}
GRAPH_PROMPTS = ["The quick brown fox jumps over the lazy dog. " * 3, "graph replay " * 5]


def _graph_engines(card, **kw):
    """An engine on the decode loop's graph path and one on the host loop
    (EnvFlags(sync_steps=True)) with the same weights."""
    cfg = EngineConfig(**{**GRAPH_CFG, **kw})
    eng = Engine(cfg, device=card)
    host = Engine(cfg, device=card, flags=EnvFlags(sync_steps=True),
                  target_params=eng.target.params,
                  draft_params=eng.draft.params if eng.draft is not None else eng._draft_params)
    return eng, host


RESULT_KEYS = ("generated_ids", "token_logprobs", "prompt_logprobs", "steps", "proposed",
               "accepted", "bonus_tokens")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_decode_loop_replays_give_the_host_loops_bits(card, case):
    """Engine.generate_batch at B = 1 and 2 through CUDA-graph replays of the
    decode step gives the host loop's ids, logprobs (to the 6 decimals the
    results keep), steps and counts, on contiguous, paged, int8 and ring
    caches, spec and baseline;
    the captured step holds the path's decode kernels (rms_norm once a
    forward, add_rms_norm twice a layer, no prefill kernel), and a chunk
    of replays moves no wrapper's launch count."""
    eng, host = _graph_engines(card, **GRAPH_CASES[case])
    for prompts in (GRAPH_PROMPTS[:1], GRAPH_PROMPTS):
        got, want = eng.generate_batch(prompts), host.generate_batch(prompts)
        for g, w in zip(got, want, strict=True):
            for key in RESULT_KEYS:
                assert g[key] == w[key], (case, key, g[key], w[key])
    assert len(eng._decode_states) == 2
    for state, loop in eng._decode_states.values():
        assert loop.graph is not None and loop.replays > 0
        per = loop.per_replay
        assert per["forwards"] == (eng._max_k + 1 if eng.is_spec else 1)
        assert per["rms_norm"] == per["forwards"] and per["add_rms_norm"] == 2 * per["layers"]
        assert per["verify_prefix"] == (1 if eng.is_spec else 0)
        assert per["flash_prefill"] == per["flash_prefill_int8"] == 0
        assert per["quant_matmul_int4_mma"] == 0 and per["quant_matmul_int4"] > 0
        counts = {name: w.launches for name, w in kernel_wrappers().items()}
        replayed = dict(DecodeLoop.replayed)
        loop(state, 2)
        torch.cuda.synchronize()
        assert counts == {name: w.launches for name, w in kernel_wrappers().items()}
        assert DecodeLoop.replayed["replays"] == replayed.get("replays", 0) + 2


@pytest.mark.cuda
def test_batcher_replays_give_the_host_steps_bits(card):
    """A paged ContinuousBatcher on the decode loop (bound at construction)
    gives the results of one on the functional step (ids, logprobs, counts):
    6 requests through 3 slots with budgets 3 to 17."""
    eng, host = _graph_engines(card, max_draft=2, kv_layout="paged", kv_page_size=64,
                               max_seq_len=512)
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3)
        for i, budget in enumerate((3, 17, 9, 5, 12, 16)):
            b.submit("served by replays " * (1 + i), max_new_tokens=budget)
        runs.append((b, b.run()))
    (b, got), (hb, want) = runs
    assert b._loop.graph is not None and b._loop.replays > 0 and hb._loop is None
    for g, w in zip(got, want, strict=True):
        for key in ("generated_ids", "token_logprobs", "prompt_logprobs", "proposed", "accepted",
                    "finish_reason"):
            assert g[key] == w[key], (key, g[key], w[key])


@pytest.mark.cuda
def test_card_draws_the_cpu_draws(card):
    """The counter-based key gives the card the CPU's uniforms bit for bit
    and the same sampled ids (Gumbel-max over [64, 32000] logits, every
    filter on); 2**16 draws of one row of 24 logits lie within total
    variation 0.02 of exp(proposal_log_probs)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((64, 32000), generator=g) * 3
    key = torch.tensor(seed_key(9))
    assert torch.equal(uniform(key.to(card), (64, 32000)).cpu(), uniform(key, (64, 32000)))
    kw = dict(temperature=0.8, top_k=400, top_p=0.95, min_p=0.01)
    got = sample_tokens(key.to(card), logits.to(card), **kw).cpu()
    assert torch.equal(got, sample_tokens(key, logits, **kw))
    row = torch.randn(24, generator=g) * 2
    ids = sample_tokens(key.to(card), row.to(card).expand(1 << 16, 24), **kw).cpu()
    emp = torch.bincount(ids.long(), minlength=24).double() / (1 << 16)
    tv = 0.5 * (emp - proposal_log_probs(row, **kw).exp().double()).abs().sum()
    assert tv < 0.02, tv


SLICE_CASES = {
    "ngram K=4": dict(draft_model=None, draft_mode="ngram", max_draft=4),
    "ngram K=3 paged": dict(draft_model=None, draft_mode="ngram", max_draft=3,
                            kv_layout="paged", kv_page_size=64),
    "rejection sampled, adaptive-device": dict(
        max_draft=3, greedy=False, temperature=0.8, top_p=0.95, policy="rejection",
        controller="adaptive-device", controller_params={"max_k": 4}),
    "baseline sampled": dict(draft_model=None, greedy=False, temperature=0.7, top_k=50),
    "conf_threshold": dict(max_draft=2, policy="conf_threshold"),
    "topk_agree": dict(max_draft=2, policy="topk_agree"),
    "typical": dict(max_draft=2, policy="typical"),
    "host adaptive": dict(max_draft=2, controller="adaptive",
                          controller_params={"max_k": 4, "target_acceptance": 0.5}),
    "medusa K=3": dict(draft_model=None, draft_mode="medusa", max_draft=3),
    "medusa K=2 sampled": dict(draft_model=None, draft_mode="medusa", max_draft=2,
                               greedy=False, temperature=0.8),
    "eagle K=2": dict(draft_model=None, draft_mode="eagle", max_draft=2),
    "tree [3, 2]": dict(draft_model=None, draft_mode="tree"),
    "tree [2, 2] paged int8 KV": dict(draft_model=None, draft_mode="tree",
                                      tree={"branching": [2, 2]}, kv_layout="paged",
                                      kv_page_size=64, kv_quantization="int8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_slice_paths_replay_the_host_loops_bits(card, case):
    """ngram, sampling, the policies and both adaptive controllers through
    the graph path give the host loop's results at B = 1 and 2 (the host
    adaptive controller: one-step graphs a K against the functional step);
    a sampled path repeats under its seed and moves with another."""
    eng, host = _graph_engines(card, **SLICE_CASES[case])
    for prompts in (GRAPH_PROMPTS[:1], GRAPH_PROMPTS):
        got, want = eng.generate_batch(prompts, seed=5), host.generate_batch(prompts, seed=5)
        for g, w in zip(got, want, strict=True):
            for key in RESULT_KEYS + ("controller",):
                assert g[key] == w[key], (case, key, g[key], w[key])
    if case == "host adaptive":
        assert len({k for _, _, k in eng.adaptive_loops}) > 1
        assert all(loop.graph is not None for loop in eng.adaptive_loops.values())
    if not eng.config.greedy:
        again, other = eng.generate_batch(GRAPH_PROMPTS, seed=5), eng.generate_batch(
            GRAPH_PROMPTS, seed=6)
        assert [r["generated_ids"] for r in again] == [r["generated_ids"] for r in got]
        assert [r["generated_ids"] for r in other] != [r["generated_ids"] for r in got]


@pytest.mark.cuda
def test_ngram_batcher_replays_give_the_host_steps_bits(card):
    eng, host = _graph_engines(card, draft_model=None, draft_mode="ngram", max_draft=4,
                               kv_layout="paged", kv_page_size=64, max_seq_len=512)
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3)
        for i, budget in enumerate((3, 17, 9, 5, 12, 16)):
            b.submit("served by replays " * (1 + i), max_new_tokens=budget)
        runs.append(b.run())
    for g, w in zip(*runs, strict=True):
        for key in ("generated_ids", "token_logprobs", "proposed", "accepted"):
            assert g[key] == w[key], (key, g[key], w[key])


@pytest.mark.cuda
def test_graph_keeps_an_outgrown_ticket_buffer(card):
    """The ticket counters grow to a new buffer while a graph captured with
    the old one lives: the old buffer is kept, so the graph's replays stay
    right even after its memory would have been handed out again."""
    eng, host = _graph_engines(card, max_draft=1)
    first = eng.generate(GRAPH_PROMPTS[0])
    old = fd.ticket_counters(card, 1)
    grown = fd.ticket_counters(card, old.numel() + 1)
    assert grown.numel() > old.numel() and any(b is old for b in fd._outgrown)
    torch.cuda.empty_cache()
    junk = [torch.full_like(old, 7) for _ in range(64)]  # would reuse a freed block
    again, want = eng.generate(GRAPH_PROMPTS[0]), host.generate(GRAPH_PROMPTS[0])
    del junk
    for key in RESULT_KEYS:
        assert again[key] == first[key] == want[key], key
    assert not old.any() and not grown[:old.numel()].any()


@pytest.mark.cuda
def test_capture_of_a_step_that_reads_the_host_raises(card):
    """A step that reads a value back to the host (here int() of a device
    scalar) cannot be captured: the loop raises and does not run it
    eagerly, and stays unbound. (Last in the file: a failed capture is the
    one test that leaves the card's stream state unusual.)"""
    eng, _ = _graph_engines(card, max_draft=1)
    state = eng._init_state(1, 256)

    def reads_the_host(s):
        eng._step_in_place(s)
        if int(s.steps) > 1000:
            raise AssertionError("unreachable")
        return s

    loop = make_decode_loop(reads_the_host)
    before = state.steps.clone()
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        loop(state, 3)
    torch.cuda.synchronize()
    assert loop.graph is None and loop.bound is None and torch.equal(state.steps, before)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_tree_variants_match_plain_and_each_other(card, cache, layout):
    """D's and F's tree variants (S = 10, tree [3, 2], 3B geometry) within
    _attn_within of the plain version, with 64 in V at every leaf's slot
    (only the leaf may see it) and past the chunk, chunks mid-cache, at the
    cache's end and at slot -1; F gives D's bits on the same keys; one
    launch a call, counted apart from the chain kernels."""
    from llm_inference_lab_tpu_torch.core.treespec import TreeConfig
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode_tree,
        flash_decode_tree_int8,
    )
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_tree, paged_flash_tree_int8

    g = torch.Generator(device=card).manual_seed(12)
    _, depths, _, anc = TreeConfig((3, 2)).build()
    anc = torch.from_numpy(anc).to(card)
    S, B, H, KVH, T, D = 10, 3, 24, 8, 1024, 128
    start = torch.tensor([517, T - S, -1], device=card, dtype=torch.int32)
    if cache == "int8":
        (k, ks), (v, vs) = (_int8_cache(card, g, (B, KVH, T, D)) for _ in "kv")
        scales, dk, fk = (ks, vs), flash_decode_tree_int8, paged_flash_tree_int8
    else:
        k, v = (torch.randn((B, KVH, T, D), generator=g, device=card).bfloat16() for _ in "kv")
        scales, dk, fk = (), flash_decode_tree, paged_flash_tree
    for b, c in enumerate(start.tolist()):
        hidden = [c + i for i in range(S) if depths[i] == 2 and c + i >= 0]
        hidden += list(range(max(c + S, 0), T))
        v[b, :, hidden] = 64 if cache == "bf16" else 127
    q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
    pos = torch.zeros((B, S), device=card, dtype=torch.int32)
    before = dk.launches
    ref = dk(q, k, v, anc, start, *scales)
    assert dk.launches == before + 1
    assert _attn_within(ref, q, k, v, pos, *scales, tree_mask=anc, chunk_start=start)
    if layout == "paged":
        pools = []
        for t in (k, v, *scales):
            g_t = torch.Generator(device=card).manual_seed(3)  # one table for all four
            pool, table = _pool_of(card, g_t, t, 64)
            pools.append(pool)
        got = fk(q, pools[0], pools[1], table, anc, start, *pools[2:])
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_tree_variant_refuses_more_than_32_rows(card):
    """A tree whose verify chunk outgrows one 32-bit ancestry word raises on
    the card, naming the limit; so does a window with the tree mask."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_tree

    S = 33
    q = torch.zeros((1, S, 8, 64), device=card, dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 128, 64), device=card, dtype=torch.bfloat16)
    anc = torch.ones((S, S), device=card, dtype=torch.bool)
    start = torch.zeros((1,), device=card, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="32"):
        flash_decode_tree(q, k, k, anc, start)
    with pytest.raises(NotImplementedError):
        flash_decode_tree(q[:, :4].contiguous(), k, k, anc[:4, :4].contiguous(), start,
                          window=16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["medusa", "tree"])
def test_head_mode_batcher_replays_give_the_host_steps_bits(card, mode):
    """The batcher in a head mode (admission seeds the hidden carry) on the
    decode loop gives the functional step's results."""
    eng, host = _graph_engines(card, draft_model=None, draft_mode=mode, max_draft=2,
                               kv_layout="paged", kv_page_size=64, max_seq_len=512)
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3)
        for i, budget in enumerate((3, 17, 9, 5, 12, 16)):
            b.submit("served by replays " * (1 + i), max_new_tokens=budget)
        runs.append(b.run())
    for g, w in zip(*runs, strict=True):
        for key in ("generated_ids", "token_logprobs", "proposed", "accepted"):
            assert g[key] == w[key], (key, g[key], w[key])


PER_REQUEST = [dict(temperature=0.0), dict(temperature=0.9, top_k=40, top_p=0.9, seed=5),
               dict(frequency_penalty=1.0, presence_penalty=0.5, repetition_penalty=1.3),
               dict(logit_bias={65: 5.0, 66: -100.0}, temperature=1.2, min_p=0.05),
               dict(temperature=0.7, seed=11), dict()]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["vanilla K=2", "tree"])
def test_per_request_batcher_replays_give_the_host_steps_bits(card, mode):
    """Per-request sampling on the card (the captured step reads each slot's
    filters, penalties, bias and key from the state): 6 requests through 3
    slots, greedy, sampled, seeded, penalized (not in the tree) and biased,
    give the functional step's ids, logprobs and top-3 lists on the decode
    loop's replays."""
    kw = (dict(max_draft=2) if mode == "vanilla K=2"
          else dict(draft_model=None, draft_mode="tree"))
    eng, host = _graph_engines(card, kv_layout="paged", kv_page_size=64, max_seq_len=512,
                               per_request_sampling=True, logprobs_topk=3, **kw)
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3)
        for i, (budget, controls) in enumerate(zip((3, 17, 9, 5, 12, 16), PER_REQUEST)):
            if mode == "tree":
                controls = {k: v for k, v in controls.items() if not k.endswith("penalty")}
            b.submit("served by replays " * (1 + i), max_new_tokens=budget, **controls)
        runs.append(b.run())
    for g, w in zip(*runs, strict=True):
        for key in ("generated_ids", "token_logprobs", "top_logprobs", "proposed", "accepted"):
            assert g[key] == w[key], (key, g[key], w[key])
    assert 66 not in runs[0][3]["generated_ids"]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_prefix_suffix_prefill_over_gathered_pages(card, int8):
    """A prefix-cached admission's attention (ops/attention.py paged_attend
    with S > 32): the suffix's 192 queries from reuse_len = 320 over one
    sequence's gathered page view (T = M * P = 1024, shuffled 64-row pages),
    the query span shorter than the key span and starting past key 0, V
    past the last position 64. Kernel E runs once and is within the
    tolerance of the plain version, and gives the bits of E over the same
    keys laid out contiguously."""
    rng = np.random.default_rng(320 + int8)
    S, D, H, KVH, P, reuse = 192, 128, 24, 8, 64, 320
    q, kp, vp, table, _ = _paged(card, rng, 1, S, H, KVH, D, P)
    pos = (reuse + torch.arange(S, dtype=torch.int32, device=card))[None]
    kc, vc = gather_pages(kp, table), gather_pages(vp, table)
    vc[:, :, reuse + S:] = 64.0
    for j in range(table.shape[1]):  # the poison back into the pages
        vp[table[0, j]] = vc[0, :, j * P:(j + 1) * P]
    scales = ()
    route = flash_prefill
    if int8:
        (kp, ksp), (vp, vsp) = quantize_rows(kp.float()), quantize_rows(vp.float())
        kc, vc = gather_pages(kp, table), gather_pages(vp, table)
        scales = (gather_pages(ksp, table), gather_pages(vsp, table))
        route = flash_prefill_int8
    before = route.launches
    got = paged_attend(q, kp, vp, pos, table, *((ksp, vsp) if int8 else ()))
    assert route.launches == before + 1
    assert _attn_within(got, q, kc, vc, pos, *scales)
    assert torch.equal(route(q, kc, vc, pos, *scales), got)


@pytest.mark.cuda
def test_lazy_batcher_preempts_on_the_card(card):
    """Lazy pages on the card: GRAPH_CFG's int4 llama-3.2-1b (no draft), 2
    slots over 7 usable pages of 16 rows, two requests of 48 tokens that
    cannot both grow: the youngest is preempted, resumes by recompute and
    every request runs its budget; the decode loop's replays give the host
    step's ids, logprobs and stats, and every page comes back."""
    cfg = EngineConfig(**{**GRAPH_CFG, "draft_model": None, "max_draft": 2,
                          "max_new_tokens": 48, "kv_layout": "paged", "kv_page_size": 16,
                          "kv_pages": 8, "eos_token_id": -1})
    eng = Engine(cfg, device=card)
    host = Engine(cfg, device=card, flags=EnvFlags(sync_steps=True),
                  target_params=eng.target.params)
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=2)
        for p in ("preempt victim check", "preempt survivor check"):
            b.submit(p)
        runs.append((b, b.run()))
    (b, got), (hb, want) = runs
    assert b.stats.preemptions >= 1 and b.stats.page_grows > 0
    assert [b.stats.preemptions, b.stats.page_grows] == [hb.stats.preemptions,
                                                           hb.stats.page_grows]
    for g, w in zip(got, want, strict=True):
        assert len(g["generated_ids"]) == 48
        for key in ("generated_ids", "token_logprobs", "finish_reason"):
            assert g[key] == w[key], (key, g[key], w[key])
    assert b.allocator.free_pages == 7 and not b.state.target_cache.table.any()


@pytest.mark.cuda
def test_capture_after_dead_batchers_in_reference_cycles(card):
    """Batchers of other engines dropped in reference cycles (each holding
    its captured graph, its caches and its engine's graph pool) before a
    new batcher captures its step, with a collection due at almost every
    allocation: DecodeLoop collects them before the capture and keeps the
    collector off inside it (freeing a graph's pool there would invalidate
    the capture); the new batcher then serves."""
    cfg = EngineConfig(**{**GRAPH_CFG, "max_draft": 1})
    eng = Engine(cfg, device=card)
    for _ in range(2):
        dead = ContinuousBatcher(Engine(cfg, device=card, target_params=eng.target.params,
                                        draft_params=eng.draft.params), n_slots=2)
        dead.cycle = dead
        del dead
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        b = ContinuousBatcher(eng, n_slots=2)
    finally:
        gc.set_threshold(*thresholds)
    assert b._loop.graph is not None and gc.isenabled()
    b.submit("captured after dead cycles", max_new_tokens=4)
    assert b.run()[0]["generated_tokens"] == 4


# (K, N) of the widths that are not a multiple of 256 columns (a tail tile):
# Qwen2.5-0.5B's qkv (1152) and o and down (896), Qwen2.5-7B's untied head
# (151,936) and Phi-3-mini's (32,064, a multiple of 64 only).
QMM_TAIL_WIDTHS = [(896, 1152), (896, 896), (4864, 896), (3584, 151936), (3072, 32064)]
QMM_TAIL_M = (1, 5, 64, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QMM_TAIL_WIDTHS)
@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_tail_columns_match_plain_and_rows_ignore_m(card, bits, K, N):
    """Kernels A and B at N % 256 != 0, through both bodies (M = 1 and 5 the
    decode body, 64 and 256 the tensor-core path): within the tolerance of
    the plain version (A: 1e-2 of the largest output; B: 2^-8 |ref| + 2^-14
    of the largest), the last columns included, and a row with the same
    bits at every M of a body."""
    x, w, scale = _qmm_inputs(card, bits, K, N, max(QMM_TAIL_M))
    kernel, plain = ((quant_matmul, quant_matmul_plain) if bits == 4 else
                     (quant_matmul_int8, quant_matmul_plain_int8))
    outs = {}
    for M in QMM_TAIL_M:
        got = kernel(x[:M], w, scale)
        ref = plain(x[:M].float(), w, scale)
        err = (got.float() - ref).abs()
        if bits == 4:
            assert err.max() <= 1e-2 * ref.abs().max(), (M, err.max())
        else:
            assert torch.all(err <= 2.0 ** -8 * ref.abs() + 2.0 ** -14 * ref.abs().max()), M
        assert ref[:, -64:].abs().max() > 0  # the tail columns are not vacuous
        outs[M] = got
    assert torch.equal(outs[5][:1], outs[1]) and torch.equal(outs[256][:64], outs[64])


# Head dim 96 (Phi-3-mini: 32 heads, no GQA, its odd window of 2047) and a
# GQA group of 7 (Qwen2.5-0.5B's 14 / 2 at head dim 64, Qwen2.5-7B's 28 / 4
# at 128).
NEW_GEOMETRIES = [(96, 32, 32, 2047), (64, 14, 2, None), (128, 28, 4, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,KVH,window", NEW_GEOMETRIES)
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_attention_at_head_dim_96_and_group_7(card, cache, D, H, KVH, window):
    """D (S = 1 and 5), E (a 160-row chunk resuming at 2400, and a prompt
    from 0) and F (D's bits through a page table) over one cache of T =
    4096, sequence 0 at positions past the window, sequence 1 with a dead
    row; and D's and F's tree variants (S = 10, no window): each within
    _attn_within of the plain version, one launch a call."""
    from llm_inference_lab_tpu_torch.core.treespec import TreeConfig
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode_tree,
        flash_decode_tree_int8,
    )
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_tree, paged_flash_tree_int8

    g = torch.Generator(device=card).manual_seed(D + H)
    B, T = 2, 4096
    if cache == "int8":
        (k, ks), (v, vs) = (_int8_cache(card, g, (B, KVH, T, D)) for _ in "kv")
        scales = (ks, vs)
        dk, ek, fk = flash_decode_int8, flash_prefill_int8, paged_flash_int8
        tdk, tfk = flash_decode_tree_int8, paged_flash_tree_int8
    else:
        k, v = (torch.randn((B, KVH, T, D), generator=g, device=card).bfloat16() for _ in "kv")
        scales = ()
        dk, ek, fk = flash_decode, flash_prefill, paged_flash
        tdk, tfk = flash_decode_tree, paged_flash_tree
    opts = {"window": window} if window else {}
    pools = []
    for t in (k, v, *scales):
        g_t = torch.Generator(device=card).manual_seed(7)  # one table for all four
        pool, table = _pool_of(card, g_t, t, 64)
        pools.append(pool)
    for S, last in ((1, (3000, 1200)), (5, (4095, 700)), (160, (2559, 159))):
        last = torch.tensor(last, device=card, dtype=torch.int32)
        pos = (last[:, None] - S + 1 + torch.arange(S, device=card, dtype=torch.int32)[None])
        pos = pos.contiguous()
        pos[1, 0] = -1
        q = torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
        kernel = ek if S > 32 else dk
        before = kernel.launches
        got = kernel(q, k, v, pos, *scales, **opts)
        assert kernel.launches == before + 1
        assert _attn_within(got, q, k, v, pos, *scales, **opts), (S, D, H)
        if S <= 32:
            paged = fk(q, pools[0], pools[1], pos, table, *pools[2:], **opts)
            assert torch.equal(paged, got), S
    _, _, _, anc = TreeConfig((3, 2)).build()
    anc = torch.from_numpy(anc).to(card)
    start = torch.tensor([517, T - 10], device=card, dtype=torch.int32)
    q = torch.randn((B, 10, H, D), generator=g, device=card).bfloat16()
    before = tdk.launches
    ref = tdk(q, k, v, anc, start, *scales)
    assert tdk.launches == before + 1
    zeros = torch.zeros((B, 10), device=card, dtype=torch.int32)
    assert _attn_within(ref, q, k, v, zeros, *scales, tree_mask=anc, chunk_start=start)
    assert torch.equal(tfk(q, pools[0], pools[1], table, anc, start, *pools[2:]), ref)


# ------------------------------------------------------ grammar runtime
GRAMMAR_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                   "pick": {"enum": ["red", "green"]}}}


def _grammar_tables(V):
    """The port's JSON tables on the ByteTokenizer at V (host), and random
    reachable FSM rows from CPU walks of valid tokens (plus dead,
    unconstrained and full-stack rows)."""
    from llm_inference_lab_tpu_torch.constrain import runtime as rt
    from llm_inference_lab_tpu_torch.constrain.jsonfsm import (
        compile_token_tables,
        json_char_automaton,
        token_bytes_of,
    )
    from llm_inference_lab_tpu_torch.utils.tokenizer import ByteTokenizer

    tb, tl = token_bytes_of(ByteTokenizer(), V)
    tt = compile_token_tables(json_char_automaton(), tb, tl, eos_id=0)
    cpu = rt.device_tables(tt, "cpu")
    g = np.random.default_rng(7)
    rows = []
    for walk in range(24):
        lex = tt.initial if walk % 2 else tt.initial_objonly
        state = (torch.tensor([lex], dtype=torch.int32),
                 torch.zeros((1, rt.STACK_DEPTH), dtype=torch.int32),
                 torch.zeros((1,), dtype=torch.int32))
        for _ in range(int(g.integers(0, 30))):
            mask = rt.token_mask(cpu, *state)[0].numpy().copy()
            mask[0] = False
            if not mask.any():
                break
            tok = torch.tensor([int(g.choice(np.flatnonzero(mask)))], dtype=torch.int32)
            state = rt.transition(cpu, *state, tok)
        rows.append(state)
    full = torch.full((1, rt.STACK_DEPTH), 1, dtype=torch.int32)
    rows += [(torch.tensor([rt.DEAD_STATE], dtype=torch.int32), full * 0, torch.zeros(1).int()),
             (torch.tensor([rt.UNCONSTRAINED], dtype=torch.int32), full * 0, torch.zeros(1).int()),
             (torch.tensor([tt.initial], dtype=torch.int32), full,
              torch.tensor([rt.STACK_DEPTH], dtype=torch.int32))]
    return tt, cpu, tuple(torch.cat(parts) for parts in zip(*rows))


@pytest.mark.cuda
def test_grammar_runtime_on_the_card_equals_the_cpu(card):
    """constrain/runtime.py on the card over the same tables (JSON at V =
    128256): token_mask, apply_mask, transition (valid, invalid and EOS
    tokens, an active mask), walk_window and window_mask give the CPU's
    booleans, integers and logits exactly."""
    from llm_inference_lab_tpu_torch.constrain import runtime as rt

    V = 128256
    tt, cpu, state = _grammar_tables(V)
    gpu = rt.device_tables(tt, card)
    on = tuple(t.to(card) for t in state)
    mask = rt.token_mask(cpu, *state)
    assert torch.equal(rt.token_mask(gpu, *on).cpu(), mask)
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((mask.shape[0], V), generator=g)
    assert torch.equal(rt.apply_mask(logits.to(card), mask.to(card)).cpu(),
                       rt.apply_mask(logits, mask))
    B = mask.shape[0]
    valid = torch.multinomial(mask.float() + 1e-9, 4, generator=g).int()
    toks = torch.where(torch.rand((B, 4), generator=g) < 0.2,
                       torch.randint(0, V, (B, 4), generator=g, dtype=torch.int32), valid)
    toks[::5, 0] = 0  # EOS
    active = torch.rand((B,), generator=g) < 0.8
    for args in ((toks[:, 0],), (toks[:, 1], active)):
        want = rt.transition(cpu, *state, *args)
        got = rt.transition(gpu, *on, *(a.to(card) for a in args))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    want = rt.walk_window(cpu, *state, toks)
    got = rt.walk_window(gpu, *on, toks.to(card))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert torch.equal(rt.window_mask(gpu, *got).cpu(), rt.window_mask(cpu, *want))


@pytest.mark.cuda
@pytest.mark.parametrize("grammar", ["json_schema", "tools"])
def test_constrained_replays_give_the_host_loops_bits(card, grammar):
    """Constrained decoding through CUDA-graph replays of the constrained
    step gives the host loop's ids and logprobs: generate under the
    grammar, spec K=2 and baseline, and a paged batcher mixing constrained
    and free requests; every completed constrained output parses."""
    import json

    tools = [{"type": "function", "function": {"name": "set_light", "parameters": {
        "type": "object", "properties": {"on": {"type": "boolean"}}}}}]
    kw = (dict(constrain="json_schema", constrain_schema=GRAMMAR_SCHEMA)
          if grammar == "json_schema" else dict(tools=tools))
    key = "json_schema" if grammar == "json_schema" else "tool_call:set_light"
    for spec in (dict(max_draft=2), dict(draft_model=None)):
        eng, host = _graph_engines(card, max_new_tokens=48, **kw, **spec)
        got = eng.generate_batch(GRAPH_PROMPTS, response_format=key)
        want = host.generate_batch(GRAPH_PROMPTS, response_format=key)
        for g, w in zip(got, want, strict=True):
            for key_ in RESULT_KEYS:
                assert g[key_] == w[key_], (grammar, key_, g[key_], w[key_])
            if g["generated_ids"][-1] == eng.eos_token_id:
                json.loads(g["text"])
        assert eng._fsm_loops and all(loop.graph is not None for loop in eng._fsm_loops.values())
    eng, host = _graph_engines(card, max_draft=2, kv_layout="paged", kv_page_size=64,
                               max_seq_len=512, max_new_tokens=48, **kw)
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3)
        for i, budget in enumerate((3, 40, 9, 5, 44, 16)):
            b.submit("served by replays " * (1 + i), max_new_tokens=budget,
                     response_format=key if i % 2 else None)
        runs.append((b, b.run()))
    (b, got), (_, want) = runs
    assert b._fsm_loop.graph is not None and b.stats.constrained_steps > 0
    for g, w in zip(got, want, strict=True):
        for key_ in ("generated_ids", "token_logprobs", "proposed", "accepted", "finish_reason"):
            assert g[key_] == w[key_], (key_, g[key_], w[key_])


# Kernel A's f32-output instantiation (the EmbedQuant4 tied head): the head's
# widths (K = d_model of the 3B and the 1B, N = V) at the head's row counts
# (1 and 2 at a K=1 step, 5 at K=4, 104 at the ngram batcher's verify: the
# tensor-core path).
HEAD_F32_SHAPES = [(3072, 128256), (2048, 128256)]
HEAD_F32_M = (1, 2, 5, 104)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", HEAD_F32_SHAPES)
def test_qmm_f32_matches_plain_and_is_the_bf16_kernel_unrounded(card, K, N):
    """quant_matmul_f32 (both bodies) within the f32 summation bound of its
    plain version (K * 2^-24 * sum_k |x_k w_kn| * scale_n), one launch a
    call on its own counts; and the bf16 instantiation's output is exactly
    the f32 one rounded to bf16 (the same loop: the bf16 kernel keeps its
    bits)."""
    from llm_inference_lab_tpu_torch.ops.quant import dequantize, QuantTensor
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul_f32, quant_matmul_f32_mma

    x, w, scale = _qmm_inputs(card, 4, K, N, max(HEAD_F32_M))
    wint = dequantize(QuantTensor(w, torch.ones_like(scale), 4), torch.float32)
    for M in HEAD_F32_M:
        before = (quant_matmul_f32.launches, quant_matmul_f32_mma.launches)
        got = quant_matmul_f32(x[:M], w, scale)
        mma = M >= MMA_MIN_M
        assert (quant_matmul_f32.launches - before[0],
                quant_matmul_f32_mma.launches - before[1]) == ((0, 1) if mma else (1, 0))
        assert got.dtype == torch.float32 and got.shape == (M, N)
        ref = quant_matmul_plain(x[:M], w, scale, out_dtype=torch.float32)
        bound = K * 2.0 ** -24 * (x[:M].float().abs() @ wint.abs()) * scale + 1e-30
        assert torch.all((got - ref).abs() <= bound), M
        bf16 = (quant_matmul_mma if mma else quant_matmul)(x[:M], w, scale)
        assert torch.equal(bf16, got.bfloat16()), M


def _tree_to(tree, dev):
    from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, QuantTensor

    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.data.to(dev), tree.scale.to(dev), tree.bits)
    if isinstance(tree, EmbedQuant):
        return EmbedQuant(tree.q.to(dev), tree.scale.to(dev))
    return tree.to(dev)


@pytest.mark.cuda
def test_lora_forward_on_the_card_equals_the_cpu(card):
    """A 2-layer cut of llama-3.2-1b (int4 projections, int8 head, bf16) with
    two rank-16 adapters on all seven matrices: rows [-1, 0, 1] on the card
    against the CPU's plain versions, each within 2% of the largest logit
    (bf16 activations rounded by other kernels), the adapters moving their
    rows by far more; the base row keeps the pack-free forward's bits."""
    import dataclasses

    from llm_inference_lab_tpu_torch.models import lora, transformer
    from llm_inference_lab_tpu_torch.models.base import Model
    from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-3.2-1b"], n_layers=2)
    params = transformer.init_params_quantized(cfg, torch.Generator().manual_seed(0), "cpu",
                                               mode="int4", quantize_embed=True)
    ads = [lora.make_adapter(cfg, f"a{i}", rank=16, alpha=64.0,
                             targets=("q", "k", "v", "o", "gate", "up", "down"),
                             rng=np.random.default_rng(i)) for i in range(2)]
    outs = {}
    for dev in ("cpu", card):
        p = _tree_to(params, dev)
        pack, _ = lora.build_pack(cfg, ads, dtype=torch.bfloat16, device=dev)
        m = Model(cfg, dict(p, layers=dict(p["layers"], **pack)))
        free = Model(cfg, p)
        toks = torch.tensor([[1, 5, 9, 200, 3000]] * 3, device=dev)
        pos = torch.arange(5, dtype=torch.int32, device=dev)[None].repeat(3, 1)
        zeros = torch.zeros(3, dtype=torch.int32, device=dev)
        ids = torch.tensor([-1, 0, 1], dtype=torch.int32, device=dev)
        outs[str(dev)] = m.forward(toks, pos, m.init_cache(3, 64, dev), zeros, lora_ids=ids)[0]
        base = free.forward(toks, pos, free.init_cache(3, 64, dev), zeros)[0]
        assert torch.equal(outs[str(dev)][0], base[0])
    got, want = outs[str(card)].cpu(), outs["cpu"]
    scale = want.abs().max()
    err = (got - want).abs().max()
    assert err <= 0.02 * scale, (float(err), float(scale))
    for row in (1, 2):
        assert (want[row] - want[0]).abs().max() > 5 * err


@pytest.mark.cuda
def test_lora_and_embed4_replays_give_the_host_loops_bits(card):
    """An engine with a LoRA pack (two rank-16 adapters) and the int4
    embedding: generate under each adapter and the base, and a paged
    batcher with the adapters mixed, through graph replays give the host
    loop's ids and logprobs; kernel A's f32 instantiation launched."""
    from llm_inference_lab_tpu_torch.models import lora
    from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul_f32

    cfg1b = LLAMA_CONFIGS["llama-3.2-1b"]
    ads = [lora.make_adapter(cfg1b, f"a{i}", rank=16, alpha=64.0,
                             targets=("q", "k", "v", "o", "gate", "up", "down"),
                             rng=np.random.default_rng(i)) for i in range(2)]
    cfg = EngineConfig(**{**GRAPH_CFG, "max_draft": 1, "quantize_embed": True, "embed_bits": 4})
    eng = Engine(cfg, device=card, lora_adapters=ads)
    host = Engine(cfg, device=card, flags=EnvFlags(sync_steps=True),
                  target_params=eng.target.params, draft_params=eng.draft.params,
                  lora_adapters=ads)
    before = quant_matmul_f32.launches
    for adapter in (None, "a0", "a1"):
        got = eng.generate_batch(GRAPH_PROMPTS, adapter=adapter)
        want = host.generate_batch(GRAPH_PROMPTS, adapter=adapter)
        for g, w in zip(got, want, strict=True):
            for key in RESULT_KEYS:
                assert g[key] == w[key], (adapter, key)
    assert quant_matmul_f32.launches > before
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3)
        for i, budget in enumerate((3, 12, 9, 5, 14, 16)):
            b.submit("served by replays " * (1 + i), max_new_tokens=budget,
                     lora=(None, "a0", "a1")[i % 3])
        runs.append(b.run())
    for g, w in zip(*runs, strict=True):
        for key in ("generated_ids", "token_logprobs", "proposed", "accepted"):
            assert g[key] == w[key], key


@pytest.mark.cuda
def test_poll_snapshot_on_the_card_holds_the_state_before_the_chunk(card):
    """poll_flags_async on the card: its copies go into pinned host buffers
    behind the work enqueued before it, marked by an event; read after the
    next chunk they hold the flags, lengths and tokens as they stood before
    it (while the state has moved on). Two buffer sets are written in turn,
    and a handle whose set was written again raises. run() through the
    pipelined loop gives the host-step batcher's results."""
    eng, host = _graph_engines(card, max_draft=2, kv_layout="paged", kv_page_size=64,
                               max_seq_len=512)
    b = ContinuousBatcher(eng, n_slots=3)
    for i in range(3):
        b.submit("lagged snapshot " * (1 + i), max_new_tokens=12)
    b._admit_pending()
    lengths, tokens = b.state.lengths.cpu().numpy(), b.state.tokens.cpu().numpy()
    first = b.poll_flags_async()
    b.step_chunk(4)
    flags, snap_tokens, _ = first.read()
    assert flags[3].tolist() == lengths.tolist() and (snap_tokens == tokens).all()
    assert flags[0].all() and (b.state.lengths.cpu().numpy() > lengths).all()
    assert all(first.bufs[k].is_pinned() for k in ("flags", "tokens", "logprobs"))
    second, third = b.poll_flags_async(), b.poll_flags_async()
    assert third.bufs is first.bufs and second.bufs is not first.bufs
    second.read()
    with pytest.raises(RuntimeError, match="later one"):
        first.read()
    runs = []
    for e in (eng, host):
        bb = ContinuousBatcher(e, n_slots=3)
        for i, budget in enumerate((3, 17, 9, 5, 12, 16)):
            bb.submit("pipelined on the card " * (1 + i), max_new_tokens=budget)
        runs.append(bb.run())
    for g, w in zip(*runs, strict=True):
        for key in ("generated_ids", "token_logprobs", "proposed", "accepted", "slot"):
            assert g[key] == w[key], (key, g[key], w[key])


@pytest.mark.cuda
def test_adaptive_batcher_replays_give_the_host_steps_bits(card):
    """controller="adaptive" in the batcher on the card: each chunk replays
    the one-step loop of the scheduler's K, each K's captured at its first
    chunk over the batcher's state in the engine's graph pool; the results
    equal the host-step batcher's (the functional step at each K), and the
    K moved."""
    eng, host = _graph_engines(card, max_draft=2, kv_layout="paged", kv_page_size=64,
                               max_seq_len=512, controller="adaptive",
                               controller_params={"min_k": 1, "max_k": 4,
                                                  "target_acceptance": 0.05, "window": 4})
    runs = []
    for e in (eng, host):
        b = ContinuousBatcher(e, n_slots=3, poll_every=2)
        b._calibrate_chunk_cost = lambda n, wall_ms: None
        ks = []
        inner = b._retire_finished

        def poll(flags=None, b=b, ks=ks, inner=inner):
            inner(flags)
            ks.append(b.scheduler.k)

        b._retire_finished = poll
        for i, budget in enumerate((9, 17, 12, 16)):
            b.submit("the same text again " * (1 + i), max_new_tokens=budget)
        runs.append((b.run(), ks, b))
    (got, ks, b), (want, hks, _) = runs
    assert ks == hks and len(set(ks)) > 1, ks
    assert b._k_loops and all(loop.graph is not None for loop in b._k_loops.values())
    for g, w in zip(got, want, strict=True):
        for key in ("generated_ids", "token_logprobs", "proposed", "accepted"):
            assert g[key] == w[key], (key, g[key], w[key])


@pytest.mark.cuda
def test_tp_forward_of_two_ranks_on_the_card_equals_one_process(card):
    """A model=2 forward of two gloo ranks sharing cuda:0 (int4 projections,
    the int8 embedding and tied head; kernel A on the column shards, its f32
    instantiation on the row shards, D and E at the rank's heads) against
    the single-process forward on the card, for a 96-token prefill (A's
    tensor-core path) and decode chunks of 1 and 3 tokens (its decode
    body): both ranks' logits equal, each within 1e-2 of the largest |logit|
    (QMM_RTOL: the ranks add f32 partials and round once where the whole
    kernel rounds its own sum once)."""
    import os
    import sys

    from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
    from llm_inference_lab_tpu_torch.models.transformer import init_params_quantized
    from llm_inference_lab_tpu_torch.parallel.multihost import launch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_ranks as ranks

    cfg = ModelConfig(name="tp-card", vocab_size=4096, n_layers=2, n_heads=8, n_kv_heads=4,
                      d_model=512, d_ff=1024, dtype=torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(0)
    params = init_params_quantized(cfg, g, card, mode="int4", quantize_embed=True)
    tokens = np.random.default_rng(0).integers(0, 4096, (1, 96)).astype(np.int32)
    with torch.inference_mode():
        want = ranks._forward(Model(cfg, params), tokens, (1, 3), card)
    host = ranks._to(params, "cpu")
    got = launch(ranks.tp_forward_cuda, 2, args=({"int4": (cfg, host)}, tokens), timeout=300)
    for r in range(2):
        for a, b, w in zip(got[r]["int4"], got[0]["int4"], want, strict=True):
            assert np.array_equal(a, b), ("rank", r)
            assert np.isfinite(a).all() and np.abs(a - w).max() <= 1e-2 * np.abs(w).max()
