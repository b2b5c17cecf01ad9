"""Kernels D, E and F of this checkout against the same kernels built from
another checkout (an earlier commit), on the card, with the ring off, at the
Llama paths' shapes (head dim 64 and 128, bf16 and int8 caches, every option
off, and D and E with a window that binds), with their device times taken in
turns (earlier, this, this, earlier). From the repo root of this checkout:

    git archive <commit> llm_inference_lab_tpu_torch/csrc | tar -x -C <dir>
    python3 tests/torch_attn_parent_probe.py <dir>

D and E (csrc/attn_mma.cuh) must give the earlier kernels' bits. F moved
from the CUDA-core body (attn_tile.cuh, f32 p) onto D's tensor-core body
(bf16 p), so it is held to D's bits over the same keys laid out
contiguously, and to chip_smoke.check_attn's tolerance of the plain
version, and timed beside the earlier F. The earlier
csrc/{flash_decode,flash_prefill,paged_flash}.cu are built with this
checkout's nvcc flags into a temporary directory and called through ctypes:
D and E with the entries they still have, F with its entry before the split
over T (no workspace, counters or split count). Exits non-zero if D or E
differs from the earlier bits, or F from D's or the tolerance.
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
from llm_inference_lab_tpu_torch.models.base import quantize_rows  # noqa: E402
from llm_inference_lab_tpu_torch.models.paged import gather_pages  # noqa: E402
from llm_inference_lab_tpu_torch.ops import flash_decode as fd  # noqa: E402
from llm_inference_lab_tpu_torch.ops import flash_prefill as fp  # noqa: E402
from llm_inference_lab_tpu_torch.ops import paged_flash as pf  # noqa: E402

P_, I_, LL, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The earlier C entries: D and E as they are now; F before its split over T
# (scale, softcap and window end its arguments before the stream).
OLD_SIGNATURES = {
    "flash_decode": build.SIGNATURES["flash_decode"],
    "flash_prefill": build.SIGNATURES["flash_prefill"],
    "paged_flash": {"paged_flash_bf16": [P_] * 6 + [I_] * 7 + [LL] + [F_, F_, I_] + [P_],
                    "paged_flash_int8": [P_] * 8 + [I_] * 7 + [LL] * 2 + [F_, F_, I_] + [P_]},
}
# (kernel, S, D, H, KVH, window): the Llama paths' shapes (1B: 32 / 8 heads
# of 64, 3B: 24 / 8 heads of 128); decode at position 167 of T = 256, the
# prompt prefill of 160 rows, serving's 8 slots near 250 in 64-row pages;
# D and E again with a window of 100, which binds there.
CASES = [("flash_decode", 1, 64, 32, 8, None), ("flash_decode", 2, 128, 24, 8, None),
         ("flash_decode", 5, 128, 24, 8, None), ("flash_prefill", 160, 64, 32, 8, None),
         ("flash_prefill", 160, 128, 24, 8, None), ("paged_flash", 1, 64, 32, 8, None),
         ("paged_flash", 2, 128, 24, 8, None), ("paged_flash", 5, 128, 24, 8, None),
         ("flash_decode", 5, 128, 24, 8, 100), ("flash_prefill", 160, 128, 24, 8, 100)]


def load_old(parent: str, tmp: str):
    libs = {}
    for name, fns in OLD_SIGNATURES.items():
        out = os.path.join(tmp, f"lib{name}_old.so")
        src = os.path.join(parent, "llm_inference_lab_tpu_torch", "csrc", f"{name}.cu")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(out)
        for fn, argtypes in fns.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(g, dev, kernel, S, D, H, KVH, int8):
    """q, the keys (bf16, or int8 with scales; contiguous [B, KVH, T, D] or
    pools [N, KVH, 64, D] with a table) and positions."""
    B, T = (8, 1024) if kernel == "paged_flash" else (1, 256)
    last = [246 + b for b in range(B)] if kernel == "paged_flash" else [167 if S <= 32 else 159]
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    pos = (torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
           + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
    k = torch.randn((B, KVH, T, D), generator=g, device=dev)
    v = torch.randn((B, KVH, T, D), generator=g, device=dev)
    if int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        keys = [k, v, ks, vs]
    else:
        keys = [k.bfloat16(), v.bfloat16()]
    table = None
    if kernel == "paged_flash":
        pools, table = chip_smoke.to_pages(g, dev, keys, 64)
        keys = pools
    return q, keys, pos, table


def old_call(lib, kernel, q, keys, pos, table, window):
    B, S, H, D = q.shape
    st = torch.cuda.current_stream().cuda_stream
    int8 = keys[0].dtype == torch.int8
    fn = getattr(lib, f"{kernel}_{'int8' if int8 else 'bf16'}")
    k, v = keys[:2]
    sc = [t.data_ptr() for t in keys[2:]]
    out = torch.empty_like(q)
    if kernel == "paged_flash":
        strides = [k.stride(0)] + ([keys[2].stride(0)] if int8 else [])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *sc, table.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), B, S, H, k.shape[1], table.shape[1], k.shape[2], D, *strides,
                 D ** -0.5, 0.0, window or 0, st)
    else:
        strides = [k.stride(0), k.stride(1)] + ([keys[2].stride(0), keys[2].stride(1)]
                                                 if int8 else [])
        split, nsplit = [], []
        if kernel == "flash_decode":
            opts = fd.Options(window=window)
            ws, counters, nz = fd.split_buffers(q, k.shape[1], k.shape[2], opts)
            split = [0 if t is None else t.data_ptr() for t in (ws, counters)]
            nsplit = [nz]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *sc, pos.data_ptr(), out.data_ptr(),
                 *split, B, S, H, k.shape[1], k.shape[2], D, *strides, D ** -0.5, 0.0,
                 window or 0, 0, *nsplit, st)
    build.check(err, f"earlier {kernel}")
    return out


def new_call(kernel, q, keys, pos, table, window):
    k, v, *sc = keys
    opts = {} if window is None else {"window": window}
    if kernel == "paged_flash":
        return pf.paged_flash(q, k, v, pos, table, *sc, **opts)
    fn = fd.flash_decode if kernel == "flash_decode" else fp.flash_prefill
    return fn(q, k, v, pos, *sc, **opts)


@torch.inference_mode()
def main(parent: str) -> int:
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    g = torch.Generator(device=dev).manual_seed(31)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        old = load_old(parent, tmp)
        for kernel, S, D, H, KVH, window in CASES:
            for int8 in (False, True):
                q, keys, pos, table = inputs(g, dev, kernel, S, D, H, KVH, int8)
                new = new_call(kernel, q, keys, pos, table, window)
                if kernel == "paged_flash":  # F: D's bits on the same keys, D's tolerance
                    cont = [gather_pages(t, table) for t in keys]
                    ref = fd.flash_decode(q, cont[0], cont[1], pos, *cont[2:])
                    ok = torch.equal(new, ref)
                    try:
                        err = chip_smoke.check_attn(new, q, *cont[:2], pos, *cont[2:],
                                                    what=(kernel, S, D))
                        verdict = (f"D's bits {ok}, within tolerance of plain (max err "
                                   f"{err:.3g})")
                    except AssertionError as e:
                        ok, verdict = False, f"OUT OF TOLERANCE {e}"
                else:  # D and E keep the earlier bits
                    ok = torch.equal(old_call(old[kernel], kernel, q, keys, pos, table, window),
                                     new)
                    verdict = "same bits" if ok else "BITS DIFFER"
                bad += not ok

                def old_fn():
                    return old_call(old[kernel], kernel, q, keys, pos, table, window)

                def new_fn():
                    return new_call(kernel, q, keys, pos, table, window)

                times = [chip_smoke.median_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
                o, n = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
                print(f"{kernel} {'int8' if int8 else 'bf16'} S={S} D={D} H={H} window={window}: "
                      f"{verdict}; earlier {times[0]:.4f} / "
                      f"{times[3]:.4f} ms, this {times[1]:.4f} / {times[2]:.4f} ms, "
                      f"this / earlier {n / o:.3f}", flush=True)
    print(f"{len(CASES) * 2 - bad} of {len(CASES) * 2} cases as required")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
