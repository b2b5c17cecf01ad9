"""Kernels A and B on the card. At decode M (1, 2, 5, 8, 16, 40 and 63):
the decode body (csrc/qmm_decode.cuh) at the wrapper's K split
(decode_plan) and at the splits beside it, every row with the same bits at
every M and within the plain version's tolerance, with the library call
and the bound. With the directory of an earlier checkout, also that
checkout's split-K CUDA-core kernels on the same inputs, held to the same
tolerance of the plain version (the two sum in other orders: their bits
differ on purpose) and timed in turns with this checkout's (earlier, this,
this, earlier). At prefill M (160, 512, 2048): the tensor-core path
(csrc/qmm_mma.cuh) at the wrapper's K split and the others it could take,
and the library call. Device times from chip_smoke.median_ms, weights
cycled beyond the L2. From the repo root:

    git archive <commit> llm_inference_lab_tpu_torch/csrc | tar -x -C <dir>
    python3 tests/torch_qmm_probe.py [<dir>] [--decode-only]

Prints one line per measurement; exits non-zero if a result leaves the
tolerance of its plain version or a decode row's bits depend on M.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from llm_inference_lab_tpu_torch import build  # noqa: E402
from llm_inference_lab_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from llm_inference_lab_tpu_torch.ops.flash_decode import ticket_counters  # noqa: E402
from llm_inference_lab_tpu_torch.ops.quant import QuantTensor, dequantize  # noqa: E402

# (K, N) of the projections of the five widths the paths run, and
# Mistral's untied head.
WIDTHS = {"3B": chip_smoke.QMM_3B, "1B": chip_smoke.QMM_1B, "9B": chip_smoke.QMM_9B,
          "2B": chip_smoke.QMM_2B, "Mistral-7B": chip_smoke.QMM_MISTRAL + [chip_smoke.MISTRAL_HEAD]}
PREFILL_M = (160, 512, 2048)
DECODE_M = (1, 2, 5, 8, 16, 40, 63)


def earlier_ksplit(K, N, bits):
    """The earlier split-K kernels' K split (their ksplit_for): the largest
    divisor of the 64-row chunks that keeps the grid of 256-column blocks
    within 4 x 132 blocks."""
    chunks = (K // 2 if bits == 4 else K) // 64
    return max(d for d in range(1, chunks + 1) if chunks % d == 0 and N // 256 * d <= 4 * 132)


def call(bits, x, w, scale, ks, mma=True):
    """One launch of kernel A (bits 4) or B (bits 8): the tensor-core path
    (mma) or the decode body, with K split ks."""
    M, K = x.shape
    N = w.shape[-1]
    lib = build.library(f"quant_matmul_int{bits}")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((ks, M, N), dtype=torch.float32, device=x.device) if ks > 1 else None
    if mma:
        err = getattr(lib, f"qmm_int{bits}_mma")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), 0 if ws is None else ws.data_ptr(),
            out.data_ptr(), M, K, N, ks, stream)
    else:
        counters = ticket_counters(x.device, N // qm.DECODE_BN)
        err = getattr(lib, f"qmm_int{bits}")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), 0 if ws is None else ws.data_ptr(),
            counters.data_ptr(), out.data_ptr(), M, K, N, ks, stream)
    build.check(err, "probe")
    return out


def library(bits, x, w, scale):
    if bits == 4:
        return torch.matmul(x, dequantize(QuantTensor(w, scale, 4), torch.bfloat16))
    return torch.matmul(x, w.to(torch.bfloat16)) * scale


def within(bits, got, ref):
    """chip_smoke.qmm_within without the assertion."""
    err = (got.float() - ref).abs()
    if bits == 4:
        return bool(err.max() <= chip_smoke.QMM_RTOL * ref.abs().max())
    return bool((err <= chip_smoke.QMM8_RTOL * ref.abs()
                 + chip_smoke.QMM8_MTOL * ref.abs().max()).all())


def earlier_library(parent_dir, tmp, bits):
    """The earlier checkout's split-K entry, built from its sources."""
    name = f"quant_matmul_int{bits}"
    out = os.path.join(tmp, f"lib{name}_old.so")
    src = os.path.join(parent_dir, "llm_inference_lab_tpu_torch", "csrc", f"{name}.cu")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(out), f"qmm_int{bits}")
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], \
        ctypes.c_int
    return fn


def decode(dev, parent_dir):
    g = torch.Generator(device=dev).manual_seed(4)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for bits in (4, 8):
            old = earlier_library(parent_dir, tmp, bits) if parent_dir else None
            plain = qm.quant_matmul_plain if bits == 4 else qm.quant_matmul_plain_int8
            for width, shapes in WIDTHS.items():
                for K, N in shapes:
                    rows = K // 2 if bits == 4 else K
                    L = max(2, (200 << 20) // (rows * N))
                    w = torch.randint(-128, 128, (L, rows, N), generator=g, dtype=torch.int8,
                                      device=dev)
                    sc = torch.rand((L, N), generator=g, device=dev) * 1e-3 + 1e-5
                    cyc = chip_smoke.Cycle(L)
                    x = torch.randn((max(DECODE_M), K), generator=g, device=dev).bfloat16()
                    plan = qm.decode_plan(K, N, bits)
                    nk = rows // qm.DECODE_KTILE
                    others = sorted({ks for ks in (plan // 2, plan - 1, plan + 1, 2 * plan)
                                     if 1 <= ks <= nk and ks != plan})
                    alone = torch.cat([call(bits, x[i:i + 1], w[0], sc[0], plan, mma=False)
                                       for i in range(max(DECODE_M))])
                    for M in DECODE_M:
                        xm = x[:M]
                        got = call(bits, xm, w[0], sc[0], plan, mma=False)
                        good = within(bits, got, plain(xm.float(), w[0], sc[0]))
                        same = torch.equal(got, alone[:M])
                        ok &= good and same
                        ms = chip_smoke.median_ms(
                            lambda: call(bits, xm, w[cyc()], sc[cyc.i], plan, mma=False))
                        lib = chip_smoke.median_ms(lambda: library(bits, xm, w[cyc()], sc[cyc.i]),
                                                   iters=10)
                        var = {ks: chip_smoke.median_ms(
                            lambda: call(bits, xm, w[cyc()], sc[cyc.i], ks, mma=False))
                               for ks in others}
                        b, by = chip_smoke.bound_ms(rows * N + 4 * N + 2 * M * K + 2 * M * N,
                                                    2 * M * K * N)
                        line = (f"decode int{bits} {width} K={K} N={N} M={M}: plan ks={plan} "
                                f"{ms:.4f} ms ({b / ms:.3f} of the bound {b:.4f} {by})  library "
                                f"{lib:.4f} ({ms / lib:.2f}x)  variants "
                                + " ".join(f"ks{k}={t:.4f}" for k, t in var.items())
                                + f"  within tolerance {good}, rows equal alone {same}")
                        if old is not None:
                            oks = earlier_ksplit(K, N, bits)

                            def earlier():
                                ws = torch.empty((oks, M, N), dtype=torch.float32, device=dev)
                                y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                                i = cyc()
                                build.check(old(xm.data_ptr(), w[i].data_ptr(), sc[i].data_ptr(),
                                                ws.data_ptr(), y.data_ptr(), M, K, N, oks,
                                                torch.cuda.current_stream().cuda_stream),
                                            "earlier")
                                return y

                            cyc.i = L - 1  # the next call reads layer 0
                            old_good = within(bits, earlier(), plain(xm.float(), w[0], sc[0]))
                            ok &= old_good
                            def this():
                                return call(bits, xm, w[cyc()], sc[cyc.i], plan, mma=False)

                            t = [chip_smoke.median_ms(f) for f in (earlier, this, this, earlier)]
                            line += (f"; earlier split-K {t[0]:.4f} / {t[3]:.4f} ms, this "
                                     f"{t[1]:.4f} / {t[2]:.4f} ms, earlier within tolerance "
                                     f"{old_good}")
                        print(line, flush=True)
                    del w, sc, x, alone
    return ok


def splits(K):
    nk = K // qm.MMA_KTILE
    return [ks for ks in (1, 2, 4) if nk % ks == 0 and nk // ks >= 16]


def prefill(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    ok = True
    for bits in (4, 8):
        plain = qm.quant_matmul_plain if bits == 4 else qm.quant_matmul_plain_int8
        for width, shapes in WIDTHS.items():
            for K, N in shapes:
                rows = K // 2 if bits == 4 else K
                L = max(2, (200 << 20) // (rows * N))
                w = torch.randint(-128, 128, (L, rows, N), generator=g, dtype=torch.int8,
                                  device=dev)
                sc = torch.rand((L, N), generator=g, device=dev) * 1e-3 + 1e-5
                cyc = chip_smoke.Cycle(L)
                x = torch.randn((max(PREFILL_M), K), generator=g, device=dev).bfloat16()
                plan = qm.mma_plan(K, N, bits)
                for M in PREFILL_M:
                    xm = x[:M]
                    good = within(bits, call(bits, xm, w[0], sc[0], plan),
                                  plain(xm.float(), w[0], sc[0]))
                    ok &= good
                    times = {ks: chip_smoke.median_ms(
                        lambda: call(bits, xm, w[cyc()], sc[cyc.i], ks), iters=10)
                             for ks in splits(K)}
                    lib = chip_smoke.median_ms(lambda: library(bits, xm, w[cyc()], sc[cyc.i]),
                                               iters=10)
                    ms = times[plan]
                    b, by = chip_smoke.bound_ms(rows * N + 4 * N + 2 * M * K + 2 * M * N,
                                                2 * M * K * N)
                    print(f"prefill int{bits} {width} K={K} N={N} M={M}: plan ks={plan} "
                          f"{ms:.4f} ms ({2 * M * K * N / ms / 1e9:.0f} TFLOP/s, "
                          f"{b / ms:.3f} of the bound {b:.4f} {by})  library {lib:.4f}  "
                          "variants " + " ".join(f"ks{k}={t:.4f}" for k, t in times.items())
                          + f"  within tolerance {good}", flush=True)
                del w, sc, x
    return ok


def main(argv):
    if not torch.cuda.is_available():
        print("torch_qmm_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    build.build_all(["quant_matmul_int4", "quant_matmul_int8"])
    dirs = [a for a in argv if not a.startswith("--")]
    ok = decode(dev, dirs[0] if dirs else None)
    if "--decode-only" not in argv:
        ok &= prefill(dev)
    print("probe ok" if ok else "probe FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
