#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llm_inference_lab_tpu_torch) on one
NVIDIA card: the quickest proof that the port builds and runs on the GPU.

    python3 chip_smoke.py            # phases 0-4, last line a JSON result
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one run

Phases, in order (any failure exits non-zero; nothing is caught and ignored):
 0. the card: nvidia-smi name and power limit, torch's device name;
 1. build every kernel from csrc/ (one nvcc per source, in parallel);
 2. each kernel against its plain PyTorch version on the card, at the main
    path's shapes, with its time, the plain version's, one library call's
    and the bound (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16);
 3. end to end at full width: Engine with an int4 llama-3.2-3b target and
    llama-3.2-1b draft (random weights from a seed, int8 embedding/tied
    head), K=1, greedy, 64 new tokens, max_seq_len 512, on bench.py's
    prompt: one warm-up, three timed generate calls with every kernel's
    launch count set to 0 just before and read just after; greedy spec ids
    must equal a baseline run's and repeat exactly, logprobs finite, and a
    run drafting with the target's own weights must accept drafts and give
    the same ids;
 4. the kernels' JSON line, then the result line.

Without CUDA it exits non-zero before printing any result.
"""

import json
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
FLASH_RTOL, FLASH_ATOL = 2.0 ** -8, 2.0 ** -16
# flash_decode checks fill V past the last position with this value, so a
# mask that lets one masked key in moves an output by about POISON / T.
POISON = 64.0


def log(*a):
    print(*a, flush=True)


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


def phase_end_to_end(dev, profile):
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul
    from llm_inference_lab_tpu_torch.ops.verify import verify_prefix

    cfg = EngineConfig(base_model="llama-3.2-3b", draft_model="llama-3.2-1b", max_draft=1,
                       max_new_tokens=64, max_seq_len=512, quantization="int4",
                       quantized_init=True, quantize_embed=True, seed=0)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"engine init (random int4 weights on the card): {time.perf_counter() - t0:.1f} s")
    eng.generate(PROMPT)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"quant_matmul_int4": quant_matmul, "flash_decode": flash_decode,
                "verify_prefix": verify_prefix}
    for w in wrappers.values():
        w.launches = 0
    runs = [eng.generate(PROMPT) for _ in range(3)]
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"launches in the 3 timed runs: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on the main path"
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
        profile_run(eng, statistics.median(r["latency_ms"] for r in runs))
    return launches


def profile_run(eng, latency_ms):
    """Kernel time by name over one profiled generate, and the device's busy
    share: the union of the kernels' intervals over the latency of an
    unprofiled generate (latency_ms; the profiler slows the host, not the
    kernels). GPU-side annotations of PyTorch ops are left out: they would
    count their kernels twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(PROMPT)
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
    log(f"profile: {len(kernels)} kernels in one generate, busy {busy_us / 1e3:.1f} ms; "
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

    kernels = {
        "quant_matmul_int4": (phase_quant_matmul(dev), "ops/pallas/quant_matmul.py:76"),
        "flash_decode": (phase_flash_decode(dev), "ops/pallas/flash_decode.py:146"),
        "verify_prefix": (phase_verify_prefix(dev), "ops/pallas/verify_pallas.py:46"),
    }
    launches = phase_end_to_end(dev, "--profile" in argv)

    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"llm_inference_lab_tpu_torch/csrc/{name}.cu",
         "replaces": f"llm_inference_lab_tpu/{where}",
         "launches": launches[name],
         "max_abs_err": agg["max_abs_err"],
         "ms": agg["ms"], "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
         "bound_by": agg["bound_by"], "library_ms": agg["library_ms"],
         "per": "one K=1 decode step (all of its calls at the main path's shapes)"}
        for name, (agg, where) in kernels.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
