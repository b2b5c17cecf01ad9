"""Kernels A and B on the card at prefill shapes: the tensor-core path
(csrc/qmm_mma.cuh) at the wrapper's K split and at the other splits it
could take, the split-K CUDA-core kernel on the same call, and
the library call, with device times (chip_smoke.median_ms, weights cycled
beyond the L2). With the directory of an earlier checkout, also the earlier
split-K kernels at every decode M (1, 2, 5, 8, 16, 40) against this
checkout's, bit for bit, and timed in turns (earlier, this, this, earlier).
From the repo root:

    git archive <commit> llm_inference_lab_tpu_torch/csrc | tar -x -C <dir>
    python3 tests/torch_qmm_probe.py [<dir>]

Prints one line per measurement; exits non-zero if a result leaves the
tolerance of its plain version or an M < 64 row differs from the earlier
kernel's.
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
from llm_inference_lab_tpu_torch.ops.quant import QuantTensor, dequantize  # noqa: E402

# (K, N) of the projections of the four widths the paths run, and
# Mistral's untied head.
WIDTHS = {"3B": chip_smoke.QMM_3B, "1B": chip_smoke.QMM_1B,
          "9B": [(3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584)],
          "Mistral-7B": [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000)]}
PREFILL_M = (160, 512, 2048)
DECODE_M = (1, 2, 5, 8, 16, 40)


def call(bits, x, w, scale, ks, mma=True):
    """One launch of kernel A (bits 4) or B (bits 8): the tensor-core path
    with K split ks, or (mma False) the split-K kernel."""
    M, K = x.shape
    N = w.shape[-1]
    lib = build.library(f"quant_matmul_int{bits}")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if mma:
        ws = torch.empty((ks, M, N), dtype=torch.float32, device=x.device) if ks > 1 else None
        err = getattr(lib, f"qmm_int{bits}_mma")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), 0 if ws is None else ws.data_ptr(),
            out.data_ptr(), M, K, N, ks, stream)
    else:
        ks = qm.ksplit_for(K, N, bits)
        ws = torch.empty((ks, M, N), dtype=torch.float32, device=x.device)
        err = getattr(lib, f"qmm_int{bits}")(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                             ws.data_ptr(), out.data_ptr(), M, K, N, ks, stream)
    build.check(err, "probe")
    return out


def library(bits, x, w, scale):
    if bits == 4:
        return torch.matmul(x, dequantize(QuantTensor(w, scale, 4), torch.bfloat16))
    return torch.matmul(x, w.to(torch.bfloat16)) * scale


def splits(K):
    nk = K // qm.MMA_KTILE
    return [ks for ks in (1, 2, 4) if nk % ks == 0 and nk // ks >= 16]


def prefill(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    ok = True
    for bits in (4, 8):
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
                    ref = (qm.quant_matmul_plain if bits == 4 else qm.quant_matmul_plain_int8)(
                        xm.float(), w[0], sc[0])
                    got = call(bits, xm, w[0], sc[0], plan).float()
                    err = (got - ref).abs()
                    good = bool((err <= 2.0 ** -8 * ref.abs() + 2.0 ** -14 * ref.abs().max()).all())
                    ok &= good
                    times = {ks: chip_smoke.median_ms(
                        lambda: call(bits, xm, w[cyc()], sc[cyc.i], ks), iters=10)
                             for ks in splits(K)}
                    lib = chip_smoke.median_ms(lambda: library(bits, xm, w[cyc()], sc[cyc.i]),
                                               iters=10)
                    old = chip_smoke.median_ms(
                        lambda: call(bits, xm, w[cyc()], sc[cyc.i], 0, mma=False), iters=3,
                        warmup=1)
                    ms = times[plan]
                    tflops = 2 * M * K * N / ms / 1e9
                    b, by = chip_smoke.bound_ms(rows * N + 4 * N + 2 * M * K + 2 * M * N,
                                                2 * M * K * N)
                    print(f"int{bits} {width} K={K} N={N} M={M}: plan ks={plan} "
                          f"{ms:.4f} ms ({tflops:.0f} TFLOP/s, "
                          f"{b / ms:.3f} of the bound {b:.4f} {by})  library {lib:.4f}  "
                          f"split-K kernel {old:.4f}  variants "
                          + " ".join(f"ks{k}={t:.4f}" for k, t in times.items())
                          + f"  within tolerance {good}", flush=True)
                del w, sc, x
    return ok


def parent(dev, parent_dir):
    """The earlier split-K kernels against this checkout's at every decode M:
    bits, and times in turns (earlier, this, this, earlier)."""
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(4)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for bits in (4, 8):
            name = f"quant_matmul_int{bits}"
            out = os.path.join(tmp, f"lib{name}_old.so")
            src = os.path.join(parent_dir, "llm_inference_lab_tpu_torch", "csrc", f"{name}.cu")
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src], check=True,
                           capture_output=True)
            old = ctypes.CDLL(out)
            fn = getattr(old, f"qmm_int{bits}")
            fn.argtypes, fn.restype = [P_] * 5 + [I_] * 4 + [P_], ctypes.c_int
            for K, N in chip_smoke.QMM_3B + chip_smoke.QMM_1B:
                rows = K // 2 if bits == 4 else K
                w = torch.randint(-128, 128, (rows, N), generator=g, dtype=torch.int8, device=dev)
                sc = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-5
                x = torch.randn((max(DECODE_M), K), generator=g, device=dev).bfloat16()
                for M in DECODE_M:
                    xm = x[:M]
                    ks = qm.ksplit_for(K, N, bits)

                    def earlier():
                        ws = torch.empty((ks, M, N), dtype=torch.float32, device=dev)
                        y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                        build.check(fn(xm.data_ptr(), w.data_ptr(), sc.data_ptr(), ws.data_ptr(),
                                       y.data_ptr(), M, K, N, ks,
                                       torch.cuda.current_stream().cuda_stream), "earlier")
                        return y

                    kernel = qm.quant_matmul if bits == 4 else qm.quant_matmul_int8
                    same = torch.equal(earlier(), kernel(xm, w, sc))
                    ok &= same
                    t = [chip_smoke.median_ms(f) for f in
                         (earlier, lambda: kernel(xm, w, sc), lambda: kernel(xm, w, sc), earlier)]
                    print(f"int{bits} K={K} N={N} M={M}: earlier == this (bits) {same}; earlier "
                          f"{t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms",
                          flush=True)
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
    ok = parent(dev, argv[0]) if argv else True
    ok &= prefill(dev)
    print("probe ok" if ok else "probe FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
