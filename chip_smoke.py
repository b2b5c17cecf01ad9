#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llm_inference_lab_tpu_torch) on one
NVIDIA card: the quickest proof that the port builds and runs on the GPU.

    python3 chip_smoke.py            # phases 0-4, last line a JSON result
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one run

Phases, in order (any failure exits non-zero; nothing is caught and ignored):
 0. the card: nvidia-smi name and power limit, torch's device name;
 1. build every kernel from csrc/ (one nvcc per source, in parallel);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes its path gives it, with its time, the plain version's, one
    library call's and the bound (bytes at 3.35 TB/s, operations at 989
    TFLOP/s bf16): quant_matmul_int4, flash_decode and verify_prefix at the
    B=1 main path's shapes, flash_prefill at admission prefills (and
    resumed chunks), paged_flash at the serving step's;
 3. end to end at full width: Engine with an int4 llama-3.2-3b target and
    llama-3.2-1b draft (random weights from a seed, int8 embedding/tied
    head), K=1, greedy, 64 new tokens, max_seq_len 512, on bench.py's
    prompt: one warm-up, three timed generate calls with every kernel's
    launch count set to 0 just before and read just after; greedy spec ids
    must equal a baseline run's and repeat exactly, logprobs finite, and a
    run drafting with the target's own weights must accept drafts and give
    the same ids;
 3b. serving at full width, the same weights: ContinuousBatcher over a paged
    KV cache (page 64, max_seq_len 1024, 8 slots), 16 requests of 45-360
    tokens and 16-64 new tokens, so that 8 wait and are admitted as slots
    retire; every kernel's count set to 0 just before run() and read just
    after. All requests retire with finite logprobs; each request's ids
    equal the start of phase 3's B=1 Engine.generate ids for its prompt (a
    difference must be a near tie at an op found to round a row differently
    at another batch shape); a contiguous-layout batcher gives the same ids;
 4. the kernels' JSON line, then the result line.

Without CUDA it exits non-zero before printing any result.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
SPIN_CYCLES_PER_S = 1.98e9  # H100 SXM top SM clock: a spin lasts at least this long
L2_BYTES = 50 << 20
PROMPT = "The quick brown fox jumps over the lazy dog. " * 3
T_MAIN = 256  # cache length of the main path (P = 160, 64 new tokens, K = 1)
P_MAIN = 167  # a mid-generation position: prompt (135) + 32 tokens

# (K, N) of every int4 projection: 3B target, 1B draft.
QMM_3B = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072)]
QMM_1B = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]
# Tolerances. quant_matmul: 1e-2 of the output's largest magnitude (bf16
# output rounding, 2^-8 relative, plus f32 summation order). flash_decode:
# the kernel keeps the probabilities in f32 and rounds only its output to
# bf16, so it is held, element by element, to the plain version run on f32
# copies of the same bf16 inputs (whose probabilities then stay f32 too):
# |got - ref| <= 2^-8 |ref| (the output's bf16 rounding) + 2^-16 (f32
# summation order). verify_prefix: exact.
QMM_RTOL = 1e-2
FLASH_RTOL, FLASH_ATOL = 2.0 ** -8, 2.0 ** -16  # flash_prefill and paged_flash too
# The attention checks fill V past the last position with this value, so a
# mask that lets one masked key in moves an output by about POISON / T.
POISON = 64.0
GEOMS = {64: (32, 8), 128: (24, 8)}  # head dim: (H, KVH) of the 1B and the 3B
LAYERS = {64: 16, 128: 28}  # layers of the model with that head dim
# Serving (phase 3b): request i's prompt and budget.
SERVE_PROMPTS = ["The quick brown fox jumps over the lazy dog. " * (1 + i % 8) for i in range(16)]
SERVE_BUDGETS = [(16, 32, 48, 64)[i % 4] for i in range(16)]
SERVE_SLOTS, SERVE_PAGE, SERVE_MAX_LEN = 8, 64, 1024


T_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def median_ms(fn, iters=25, warmup=3):
    """Median device time of one call, from CUDA events recorded between
    back-to-back calls. A first pass measures how long the host takes to
    enqueue the calls; the timed pass then queues behind a spin kernel three
    times that long, so the events time the device's work and not the
    host's launch rate. Raises if the spin did not cover the enqueue."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 2)]

    def enqueue():
        t0 = time.perf_counter()
        for i in range(iters):
            events[i + 1].record()
            fn()
        events[-1].record()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    spin_s = 3 * enqueue()
    torch.cuda.synchronize()
    events[0].record()
    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    took_s = enqueue()
    torch.cuda.synchronize()
    spun_s = events[0].elapsed_time(events[1]) / 1e3
    assert spun_s > took_s, f"timing: enqueue {took_s:.6f} s outlasted the spin {spun_s:.6f} s"
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(1, iters + 1))


def bound_ms(nbytes, nops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Cycle:
    """Hands out views of L stacked copies in turn, so that timed calls read
    from device memory as the layer loop does, not from the 50 MB L2."""

    def __init__(self, n):
        self.i, self.n = 0, n

    def __call__(self):
        self.i = (self.i + 1) % self.n
        return self.i


def phase_quant_matmul(dev):
    from llm_inference_lab_tpu_torch.ops.quant import dequantize, QuantTensor
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    g = torch.Generator(device=dev).manual_seed(1)
    rows, max_err = {}, 0.0
    for K, N in QMM_3B + QMM_1B:
        L = max(2, (200 << 20) // (K * N // 2))  # > 200 MB of weights: beyond L2
        w = torch.randint(-128, 128, (L, K // 2, N), generator=g, dtype=torch.int8, device=dev)
        sc = torch.rand((L, N), generator=g, device=dev) * (0.02 / 7) + 1e-4
        cyc = Cycle(L)
        for M in (1, 2, 160):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            got = quant_matmul(x, w[0], sc[0]).float()
            ref = quant_matmul_plain(x, w[0], sc[0]).float()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            assert torch.isfinite(got).all() and err <= QMM_RTOL * scale, (K, N, M, err, scale)
            max_err = max(max_err, err)
            if M == 2:  # row 0 rounds identically alone and inside the batch
                one = quant_matmul(x[:1].contiguous(), w[0], sc[0]).float()
                assert torch.equal(one, got[:1]), (K, N, "M-dependent rounding")
            ms = median_ms(lambda: quant_matmul(x, w[cyc()], sc[cyc.i]))
            plain = median_ms(lambda: quant_matmul_plain(x, w[cyc()], sc[cyc.i]), iters=10)
            lib = median_ms(lambda: torch.matmul(
                x, dequantize(QuantTensor(w[cyc()], sc[cyc.i], 4), torch.bfloat16)), iters=10)
            b, by = bound_ms(K // 2 * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
            rows[(K, N, M)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
            log(f"quant_matmul_int4 K={K} N={N} M={M}: {ms:.4f} ms  plain {plain:.4f}  "
                f"library {lib:.4f}  bound {b:.4f} ({by})  max_abs_err {err:.3g}")
        del w, sc
    # One K=1 decode step: 16 draft layers at M=1, 28 target layers at M=2.
    step = [(k, n, 1, 16) for k, n in QMM_1B] + [(k, n, 2, 28) for k, n in QMM_3B]
    agg = {key: sum(rows[(k, n, m)][key] * c for k, n, m, c in step)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(c for k, n, m, c in step if rows[(k, n, m)]["bound_by"] == "operations")
    agg["bound_by"] = "operations" if by_ops > len(step) // 2 else "bytes"
    agg["max_abs_err"] = max_err
    return agg


def flash_inputs(g, dev, B, S, H, KVH, T, D, p_last, L=1):
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    k = torch.randn((L, B, KVH, T, D), generator=g, device=dev).bfloat16()
    v = torch.randn((L, B, KVH, T, D), generator=g, device=dev).bfloat16()
    pos = (p_last - S + 1 + torch.arange(S, device=dev, dtype=torch.int32))[None].repeat(B, 1)
    return q, k, v, pos.contiguous()


def sdpa(q, k, v, pos):
    """One library call for the same function (timed only, never used)."""
    T = k.shape[2]
    mask = torch.arange(T, device=q.device)[None, None, None, :] <= pos[:, None, :, None]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def phase_flash_decode(dev):
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain

    g = torch.Generator(device=dev).manual_seed(2)
    geoms = {64: (32, 8), 128: (24, 8)}  # D: (H, KVH) of the 1B and the 3B
    max_err = 0.0
    for S in (1, 2, 160):
        for D, (H, KVH) in geoms.items():
            for T in (256, 4096):
                # The last position ends 8 keys into a 32-key tile: a partial
                # tile is read, and keys past it hold POISON.
                p_last = T - 57
                q, k, v, pos = flash_inputs(g, dev, 2, S, H, KVH, T, D, p_last)
                v[..., p_last + 1:, :] = POISON
                pos[1, 0] = -1  # a dead row: must be zeros
                got = flash_decode(q, k[0], v[0], pos).float()
                ref = flash_decode_plain(q.float(), k[0].float(), v[0].float(), pos)
                err = (got - ref).abs().max().item()
                excess = ((got - ref).abs() - FLASH_RTOL * ref.abs() - FLASH_ATOL).max().item()
                assert torch.isfinite(got).all() and excess <= 0, (S, D, T, err, excess)
                assert torch.all(got[1, 0] == 0), (S, D, T, "dead row not zero")
                if S == 2:  # row 0 is the same alone and inside the batch
                    one = flash_decode(q[:, :1].contiguous(), k[0], v[0],
                                       pos[:, :1].contiguous()).float()
                    assert torch.equal(one, got[:, :1]), (D, T, "S-dependent rounding")
                max_err = max(max_err, err)
                log(f"flash_decode S={S} D={D} T={T}: max_abs_err {err:.3g} (dead row zero)")
    # Timing at the main path's shapes, B=1, T=256: the draft (S=1, D=64)
    # and verify (S=2, D=128) calls of one step at position P_MAIN, and the
    # S=160 prefill of each model (once per request: not in the step's sum).
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
               max_abs_err=max_err)
    for S, D, n in ((1, 64, 16), (2, 128, 28), (160, 64, 0), (160, 128, 0)):
        H, KVH = geoms[D]
        p_last = P_MAIN if S <= 2 else S - 1
        L = 2 * L2_BYTES // (2 * KVH * T_MAIN * D * 2) + 1  # K+V copies twice the L2
        q, k, v, pos = flash_inputs(g, dev, 1, S, H, KVH, T_MAIN, D, p_last, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: flash_decode(q, k[cyc()], v[cyc.i], pos))
        plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos), iters=10)
        lib = median_ms(lambda: sdpa(q, k[cyc()], v[cyc.i], pos), iters=10)
        kv = p_last + 1  # keys the positions reach
        seen = sum(p_last - S + 2 + i for i in range(S))  # keys summed over the query rows
        b, by = bound_ms(2 * KVH * kv * D * 2 + 2 * 2 * S * H * D + 4 * S, 4 * H * seen * D)
        log(f"flash_decode S={S} D={D} T={T_MAIN} p={p_last}: {ms:.4f} ms  plain {plain:.4f}  "
            f"library {lib:.4f}  bound {b:.5f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += n * val
    return agg


def phase_verify_prefix(dev):
    from llm_inference_lab_tpu_torch.ops.verify import verify_prefix, verify_prefix_plain

    g = torch.Generator(device=dev).manual_seed(3)
    V = 128256
    # Main path: the first K rows of the [1, K+1, V] verify logits, K = 1.
    full = torch.randn((1, 2, V), generator=g, device=dev)
    lg1 = full[:, :-1]
    d1 = torch.argmax(lg1, -1).to(torch.int32)
    # [4, 4, V] with a forced tie, a NaN in a matching row, an all-NaN row.
    lg4 = torch.randn((4, 4, V), generator=g, device=dev)
    d4 = torch.argmax(lg4, -1).to(torch.int32)
    d4[1, 2] += 1
    lg4[3, 1, 7] = lg4[3, 1, 9000] = lg4[3, 1].max() + 1
    d4[3, 1] = 7
    lg4[0, 3, 5] = float("nan")
    lg4[2, 0, :] = float("nan")
    for d, lg in ((d1, lg1), (d4, lg4)):
        got, ref = verify_prefix(d, lg), verify_prefix_plain(d, lg)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (got, ref)
    assert verify_prefix(d4, lg4)[0].tolist() == [3, 2, 0, 4]
    assert verify_prefix(d1, lg1)[0].tolist() == [1]
    ms = median_ms(lambda: verify_prefix(d1, lg1))
    plain = median_ms(lambda: verify_prefix_plain(d1, lg1))
    lib = median_ms(lambda: torch.argmax(lg1, -1))
    b, by = bound_ms(V * 4 + 4 + 1 + 4, V)
    log(f"verify_prefix [1,1,{V}]: {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f}  "
        f"bound {b:.5f} ({by})  exact")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by, max_abs_err=0.0)


def check_close(got, ref, what):
    """Per element within FLASH_RTOL |ref| + FLASH_ATOL; returns max abs err."""
    excess = ((got - ref).abs() - FLASH_RTOL * ref.abs() - FLASH_ATOL).max().item()
    assert torch.isfinite(got).all() and excess <= 0, (what, excess)
    return (got - ref).abs().max().item()


def sdpa_causal(q, k, v):
    """The library call for a prefill from position 0 (timed only)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, is_causal=True, enable_gqa=True)
    return out.transpose(1, 2)


def phase_flash_prefill(dev):
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill

    g = torch.Generator(device=dev).manual_seed(4)
    max_err = 0.0
    for S in (64, 160, 512):
        for D, (H, KVH) in GEOMS.items():
            # Sequence 0 prefills from position 0, sequence 1 is a chunk
            # resuming at 128; row 0 of sequence 1 is dead. T is the last
            # position rounded up to 32, or 1024.
            q, k, v, _ = flash_inputs(g, dev, 2, S, H, KVH, 1024, D, 0)
            k, v = k[0], v[0]
            ar = torch.arange(S, device=dev, dtype=torch.int32)
            pos = torch.stack([ar, 128 + ar]).contiguous()
            v[0, :, S:] = POISON
            v[1, :, 128 + S:] = POISON
            pos[1, 0] = -1
            ref = flash_decode_plain(q.float(), k.float(), v.float(), pos)
            outs = {}
            for T in (-(-(128 + S) // 32) * 32, 1024):
                outs[T] = flash_prefill(q, k[:, :, :T], v[:, :, :T], pos)
                err = check_close(outs[T].float(), ref, ("flash_prefill", S, D, T))
                max_err = max(max_err, err)
                assert torch.all(outs[T][1, 0] == 0), (S, D, T, "dead row not zero")
            small, full = outs.values()
            assert torch.equal(small, full), (S, D, "depends on T past the positions")
            # A row alone equals the row inside its 32-row block, and is
            # what flash_decode (the same tile body) gives for it.
            for j in (1, S // 2 + 3, S - 1):
                qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                assert torch.equal(flash_prefill(qj, k, v, pj), full[:, j:j + 1]), (S, D, j)
                assert torch.equal(flash_decode(qj, k, v, pj), full[:, j:j + 1]), (S, D, j)
            log(f"flash_prefill S={S} D={D}: max_abs_err {err:.3g}; T-independent, "
                f"row-independent, == flash_decode per row (dead row zero)")
    # The B=1 main path's prompt prefill (S=160 at T=256), which E took over
    # from D: E beside D on the same inputs (per request, not in the wave).
    for D, (H, KVH) in GEOMS.items():
        L = 2 * L2_BYTES // (2 * KVH * T_MAIN * D * 2) + 1
        q, k, v, pos = flash_inputs(g, dev, 1, 160, H, KVH, T_MAIN, D, 159, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: flash_prefill(q, k[cyc()], v[cyc.i], pos))
        ms_d = median_ms(lambda: flash_decode(q, k[cyc()], v[cyc.i], pos))
        lib = median_ms(lambda: sdpa_causal(q, k[cyc()][:, :, :160], v[cyc.i][:, :, :160]),
                        iters=10)
        b, by = bound_ms(2 * 2 * KVH * 160 * D + 2 * 2 * 160 * H * D + 4 * 160,
                         4 * H * 160 * 161 // 2 * D)
        log(f"flash_prefill main-path prefill S=160 T={T_MAIN} D={D}: {ms:.4f} ms  "
            f"flash_decode {ms_d:.4f}  library {lib:.4f} (SDPA causal)  bound {b:.5f} ({by})")
        del k, v
    # Timing at admission prefills: G prompts of P = 256 positions into a
    # [G, KVH, 256, D] scratch. One wave = 28 3B layers and 16 1B layers.
    P = 256
    per = {}
    for G in (1, 4):
        for D, (H, KVH) in GEOMS.items():
            L = 2 * L2_BYTES // (2 * G * KVH * P * D * 2) + 1
            q = torch.randn((G, P, H, D), generator=g, device=dev).bfloat16()
            k = torch.randn((L, G, KVH, P, D), generator=g, device=dev).bfloat16()
            v = torch.randn((L, G, KVH, P, D), generator=g, device=dev).bfloat16()
            pos = torch.arange(P, device=dev, dtype=torch.int32)[None].repeat(G, 1).contiguous()
            cyc = Cycle(L)
            ms = median_ms(lambda: flash_prefill(q, k[cyc()], v[cyc.i], pos))
            plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos), iters=10)
            lib = median_ms(lambda: sdpa_causal(q, k[cyc()], v[cyc.i]), iters=10)
            seen = G * H * P * (P + 1) // 2  # (query row, key) pairs the mask keeps
            b, by = bound_ms(2 * 2 * G * P * H * D + 2 * 2 * G * KVH * P * D + 4 * G * P,
                             4 * seen * D)
            per[(G, D)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
            log(f"flash_prefill G={G} P={P} D={D}: {ms:.4f} ms  plain {plain:.4f}  "
                f"library {lib:.4f} (SDPA causal)  bound {b:.5f} ({by})")
            del k, v
    agg = {key: sum(per[(4, D)][key] * LAYERS[D] for D in GEOMS)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    agg["bound_by"] = per[(4, 128)]["bound_by"]
    agg["max_abs_err"] = max_err
    return agg


def paged_inputs(g, dev, B, S, H, KVH, D, P, last, L=1):
    """q [B, S, H, D]; contiguous K/V [L, B, KVH, 1024, D] with V past each
    sequence's last position set to POISON; the same keys in page pools
    [L, N, KVH, P, D] through one shuffled table [B, M] (page 0 unused);
    positions [B, S] ending at last[b]."""
    M = SERVE_MAX_LEN // P
    N = B * M + 1
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    kc = torch.randn((L, B, KVH, M * P, D), generator=g, device=dev).bfloat16()
    vc = torch.randn((L, B, KVH, M * P, D), generator=g, device=dev).bfloat16()
    for b in range(B):
        vc[:, b, :, last[b] + 1:] = POISON
    table = (torch.randperm(N - 1, generator=g, device=dev)[: B * M] + 1).reshape(B, M)
    table = table.to(torch.int32).contiguous()
    kp = torch.zeros((L, N, KVH, P, D), device=dev, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    for src, dst in ((kc, kp), (vc, vp)):
        dst[:, table.flatten().long()] = (src.reshape(L, B, KVH, M, P, D).transpose(2, 3)
                                          .reshape(L, B * M, KVH, P, D))
    pos = torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
    pos = (pos + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
    return q, kc, vc, kp, vp, table, pos


def phase_paged_flash(dev):
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_plain

    g = torch.Generator(device=dev).manual_seed(5)
    B, max_err = 8, 0.0
    for S in (1, 2, 5):
        for D, (H, KVH) in GEOMS.items():
            for P in (16, 64):
                last = torch.randint(S, 1001, (B,), generator=g, device=dev).tolist()
                q, kc, vc, kp, vp, table, pos = paged_inputs(g, dev, B, S, H, KVH, D, P, last)
                kc, vc, kp, vp = kc[0], vc[0], kp[0], vp[0]
                assert torch.equal(gather_pages(kp, table), kc)
                pos[1, 0] = -1
                got = paged_flash(q, kp, vp, pos, table)
                ref = paged_flash_plain(q.float(), kp.float(), vp.float(), pos, table)
                err = check_close(got.float(), ref, ("paged_flash", S, D, P))
                max_err = max(max_err, err)
                assert torch.all(got[1, 0] == 0), (S, D, P, "dead row not zero")
                assert torch.equal(got, flash_decode(q, kc, vc, pos)), (S, D, P, "bits != D")
                log(f"paged_flash B={B} S={S} D={D} P={P} (last positions up to {max(last)}): "
                    f"max_abs_err {err:.3g}; == flash_decode on the gathered keys (dead row zero)")
    # Timing at the serving step's shapes: 8 slots at positions near 250,
    # 64-row pages, 1024 positions a sequence: the draft (S=1, D=64) and
    # verify (S=2, D=128) calls of one K=1 step.
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
               max_abs_err=max_err)
    last = [246 + b for b in range(B)]
    for S, D in ((1, 64), (2, 128)):
        H, KVH = GEOMS[D]
        M = SERVE_MAX_LEN // SERVE_PAGE
        L = 2 * L2_BYTES // (2 * (B * M + 1) * KVH * SERVE_PAGE * D * 2) + 1
        q, _, _, kp, vp, table, pos = paged_inputs(g, dev, B, S, H, KVH, D, SERVE_PAGE, last, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: paged_flash(q, kp[cyc()], vp[cyc.i], pos, table))
        plain = median_ms(lambda: paged_flash_plain(q, kp[cyc()], vp[cyc.i], pos, table),
                          iters=10)
        lib = median_ms(lambda: sdpa(q, gather_pages(kp[cyc()], table),
                                     gather_pages(vp[cyc.i], table), pos), iters=10)
        keys = sum(p + 1 for p in last)  # keys the positions reach, over the sequences
        seen = sum(p - S + 2 + i for p in last for i in range(S)) * H
        b, by = bound_ms(2 * KVH * keys * D * 2 + 2 * 2 * B * S * H * D + 4 * B * S
                         + 4 * table.numel(), 4 * seen * D)
        log(f"paged_flash B={B} S={S} D={D} P={SERVE_PAGE} p~250: {ms:.4f} ms  plain "
            f"{plain:.4f}  library {lib:.4f} (gather + SDPA)  bound {b:.5f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += LAYERS[D] * val
        del kp, vp
    return agg


def phase_end_to_end(dev, profile):
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = EngineConfig(base_model="llama-3.2-3b", draft_model="llama-3.2-1b", max_draft=1,
                       max_new_tokens=64, max_seq_len=512, quantization="int4",
                       quantized_init=True, quantize_embed=True, seed=0)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"engine init (random int4 weights on the card): {time.perf_counter() - t0:.1f} s")
    eng.generate(PROMPT)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    runs = [eng.generate(PROMPT) for _ in range(3)]
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"launches in the 3 timed runs: {launches}")
    for name, n in launches.items():
        # The contiguous B=1 path has no page pool; its prefill runs E.
        assert n > 0 or name == "paged_flash", f"{name} never launched on the main path"
    ids = runs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in runs), "repeated runs differ"
    for r in runs:
        lp = torch.tensor(r["token_logprobs"])
        assert len(lp) == r["generated_tokens"] and torch.isfinite(lp).all(), "bad logprobs"
    assert runs[0]["generated_tokens"] >= 1
    # The baseline is timed as the spec run is: one warm-up, median of 3.
    base_eng = Engine(replace(cfg, draft_model=None), device=dev, target_params=eng.target.params)
    base_eng.generate(PROMPT)
    bases = [base_eng.generate(PROMPT) for _ in range(3)]
    assert all(b["generated_ids"] == ids for b in bases), "speculative output differs from baseline"
    # The random 1B draft never agrees with the random 3B target, so the run
    # above rejects every draft. Drafting with the target's own weights
    # accepts drafts and runs the accept and full-accept bonus paths. (Not
    # every draft: after a full accept the draft cache lacks the last
    # draft's row, in the JAX package as in the port.)
    same = Engine(replace(cfg, draft_model=cfg.base_model), device=dev,
                  target_params=eng.target.params,
                  draft_params=eng.target.params).generate(PROMPT)
    assert same["generated_ids"] == ids, "self-drafted output differs from baseline"
    assert same["accepted"] > 0, "the self-drafted run accepted no draft"
    log(f"self-drafted 3B (target weights as draft): acceptance {same['acceptance_rate']:.4f}, "
        f"steps {same['steps']}, {same['tokens_per_sec']:.2f} tok/s; ids == baseline ids")
    def timing(rs):
        tps = statistics.median(r["tokens_per_sec"] for r in rs)
        step_ms = statistics.median(r["generation_time_ms"] / r["steps"] for r in rs)
        return (f"median {tps:.2f} tok/s, {step_ms:.3f} ms/step, "
                f"runs tok/s {[round(r['tokens_per_sec'], 2) for r in rs]}")

    log(f"end to end (3B int4 + 1B draft, K=1, B=1, 64 new tokens): {timing(runs)}, "
        f"steps {runs[0]['steps']}, acceptance {runs[0]['acceptance_rate']:.4f}, "
        f"generated {runs[0]['generated_tokens']}, peak memory {peak_mb:.1f} MB; "
        f"baseline (3B alone): {timing(bases)}, steps {bases[0]['steps']}; "
        f"spec ids == baseline ids")
    if profile:
        profile_run("generate", lambda: eng.generate(PROMPT),
                    statistics.median(r["latency_ms"] for r in runs))
    return eng, launches


def kernel_wrappers():
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul
    from llm_inference_lab_tpu_torch.ops.verify import verify_prefix

    return {"quant_matmul_int4": quant_matmul, "flash_decode": flash_decode,
            "flash_prefill": flash_prefill, "paged_flash": paged_flash,
            "verify_prefix": verify_prefix}


def row_stability(eng, dev):
    """Each dense op of a forward on 16 rows, computed one row at a time
    (M = 1) and together as the first M = 2, 8, 16 rows (B=1 generate runs
    M = 1 and 2, the 8-slot batcher 8 and 16): for each M, how many rows
    differ in any bit from the row alone. The attention kernels' rows are
    checked in their phases."""
    from llm_inference_lab_tpu_torch.models.transformer import lm_head_logits, rms_norm
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul

    cfg, params = eng.target.config, eng.target.params
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((16, cfg.d_model), generator=g, device=dev).bfloat16()
    w = params["layers"]["w_qkv"].layer(0)
    ops = {
        "rms_norm (torch mean over d_model)":
            lambda a: rms_norm(a, params["layers"]["attn_norm_scale"][0], cfg.rms_norm_eps),
        "tied int8 head (cast + torch.matmul)": lambda a: lm_head_logits(cfg, params, a),
        "quant_matmul_int4 (kernel A)": lambda a: quant_matmul(a, w.data, w.scale),
    }
    out = {}
    for name, fn in ops.items():
        alone = torch.cat([fn(x[i:i + 1].contiguous()) for i in range(16)])
        out[name] = {M: int((fn(x[:M].contiguous()) != alone[:M]).any(-1).sum())
                     for M in (2, 8, 16)}
    return out


def near_tie(eng, dev, prompt, ids_a, ids_b):
    """At the first position where two greedy runs of one prompt differ: the
    two top target logits from a fresh B=1 forward over the common prefix,
    their gap and the gap in bf16 ulps of the top logit (the head rounds
    its products to bf16)."""
    j = next(i for i, (a, b) in enumerate(zip(ids_a, ids_b)) if a != b)
    ctx = eng.tokenizer.encode(prompt) + ids_a[:j]
    n = len(ctx)
    cache = eng.target.init_cache(1, -(-n // 32) * 32, dev)
    logits, _ = eng.target.forward(
        torch.tensor([ctx], device=dev, dtype=torch.int32),
        torch.arange(n, device=dev, dtype=torch.int32)[None],
        cache, torch.zeros((1,), device=dev, dtype=torch.int32))
    top = torch.topk(logits[0, -1], 2)
    (v1, v2), (t1, t2) = top.values.tolist(), top.indices.tolist()
    ulp = 2.0 ** (math.floor(math.log2(abs(v1))) - 7)
    return dict(position=j, tokens=(ids_a[j], ids_b[j]), top2=((t1, v1), (t2, v2)),
                gap=v1 - v2, gap_ulps=(v1 - v2) / ulp)


def phase_serving(dev, eng, profile):
    """Phase 3b: the paged serving path at full width, on phase 3's weights."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine

    def batcher(layout):
        cfg = replace(eng.config, max_seq_len=SERVE_MAX_LEN, kv_layout=layout,
                      kv_page_size=SERVE_PAGE)
        b = ContinuousBatcher(Engine(cfg, device=dev, target_params=eng.target.params,
                                     draft_params=eng.draft.params), n_slots=SERVE_SLOTS)
        for prompt, budget in zip(SERVE_PROMPTS, SERVE_BUDGETS):
            b.submit(prompt, max_new_tokens=budget)
        return b

    # The contiguous batcher's run is the warm-up and the layout reference.
    contiguous = batcher("contiguous").run()
    paged = batcher("paged")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    results = paged.run()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    st = paged.stats.report()
    log(f"launches in the serving run: {launches}")
    for name, n in launches.items():
        # Paged serving decodes through F; D serves the contiguous layout.
        assert n > 0 or name == "flash_decode", f"{name} never launched while serving"
    assert len(results) == len(SERVE_PROMPTS) == st["retired"], "not every request retired"
    for r in results:
        lp = torch.tensor(r["token_logprobs"] + r["prompt_logprobs"][1:])
        assert r["generated_tokens"] >= 1 and torch.isfinite(lp).all(), ("bad result", r["req_id"])
    assert [r["generated_ids"] for r in results] == [r["generated_ids"] for r in contiguous], \
        "paged and contiguous batchers differ"
    log(f"serving (3B int4 + 1B draft, K=1, paged KV page {SERVE_PAGE}, {SERVE_SLOTS} slots, "
        f"max_seq_len {SERVE_MAX_LEN}): {len(results)} requests, {st['committed_tokens']} "
        f"generated tokens in {st['wall_s']:.3f} s = {st['tok_s']:.2f} tok/s aggregate; "
        f"{st['steps']} steps, {st['admit_waves']} admission waves, mean occupied slots "
        f"{st['mean_occupied_slots']:.2f}, peak memory {peak_mb:.1f} MB; "
        f"ids == contiguous-layout batcher ids")
    # Each request against phase 3's B=1 Engine.generate (contiguous, 64 new
    # tokens) on its prompt.
    reference = {p: eng.generate(p)["generated_ids"] for p in dict.fromkeys(SERVE_PROMPTS)}
    stability = row_stability(eng, dev)
    log("row stability (rows of M that differ from the row alone, M = 2/8/16): "
        + "; ".join(f"{op}: {d[2]}/{d[8]}/{d[16]}" for op, d in stability.items()))
    unstable = [op for op, d in stability.items() if d[8] or d[16]]
    differ = 0
    for r, prompt in zip(results, SERVE_PROMPTS):
        ref = reference[prompt][: len(r["generated_ids"])]
        if r["generated_ids"] == ref:
            continue
        differ += 1
        tie = near_tie(eng, dev, prompt, ref, r["generated_ids"])
        log(f"request {r['req_id']} differs from generate: {tie}; ops that round rows "
            f"differently at the batcher's M: {unstable}")
        assert tie["gap_ulps"] <= 2 and unstable, ("not a near tie at a named op", tie)
    log(f"serving ids == the start of B=1 generate ids for {len(results) - differ} of "
        f"{len(results)} requests (the rest near ties)")
    if profile:
        profile_run("serving run", lambda: batcher("paged").run(), st["wall_s"] * 1e3)
    return launches


def profile_run(what, fn, latency_ms):
    """Kernel time by name over one profiled call of fn, and the device's
    busy share: the union of the kernels' intervals over the latency of an
    unprofiled call (latency_ms; the profiler slows the host, not the
    kernels). GPU-side annotations of PyTorch ops are left out: they would
    count their kernels twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("profile: no device time recorded (not measured)")
        return
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for k in kernels:
        t, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), n + 1)
    log(f"profile: {len(kernels)} kernels in one {what}, busy {busy_us / 1e3:.1f} ms; "
        f"wall {wall_ms:.1f} ms with the profiler, {latency_ms:.1f} ms without; "
        f"busy share {busy_us / 1e3 / latency_ms:.3f}")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {t / 1e3:9.3f} ms  {n:6d} calls  {name[:90]}")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    log("profile: host time by op (self, with the profiler's own overhead)")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from llm_inference_lab_tpu_torch import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, out in reports.items():
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    step = "one K=1 decode step (all of its calls at the B=1 main path's shapes)"
    kernels = {
        "quant_matmul_int4": (phase_quant_matmul(dev), "ops/pallas/quant_matmul.py:76", step),
        "flash_decode": (phase_flash_decode(dev), "ops/pallas/flash_decode.py:146", step),
        "flash_prefill": (phase_flash_prefill(dev), "ops/pallas/flash_prefill.py:86",
                          "one admission wave (G=4 prompts of P=256, both models' layers)"),
        "paged_flash": (phase_paged_flash(dev), "ops/pallas/paged_flash.py:82",
                        "one K=1 decode step of the 8-slot serving batch (both models' layers)"),
        "verify_prefix": (phase_verify_prefix(dev), "ops/pallas/verify_pallas.py:46", step),
    }
    t0 = time.perf_counter()
    eng, on_generate = phase_end_to_end(dev, "--profile" in argv)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_serving = phase_serving(dev, eng, "--profile" in argv)
    log(f"phase 3b took {time.perf_counter() - t0:.1f} s")

    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"llm_inference_lab_tpu_torch/csrc/{name}.cu",
         "replaces": f"llm_inference_lab_tpu/{where}",
         "launches": on_generate[name] + on_serving[name],
         "launches_by_path": {"generate (3 runs)": on_generate[name],
                              "serving (16 requests)": on_serving[name]},
         "max_abs_err": agg["max_abs_err"],
         "ms": agg["ms"], "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
         "bound_by": agg["bound_by"], "library_ms": agg["library_ms"], "per": per}
        for name, (agg, where, per) in kernels.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
