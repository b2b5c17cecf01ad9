"""Build the CUDA kernels under csrc/ with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (nvcc for sm_90a, -O3, -shared, -fPIC), where
the hash covers the source, every ``csrc/*.cuh`` header and NVCC_FLAGS: a
changed source, a changed shared header or changed flags name a library that
does not exist yet, so it is built afresh. Nothing is
built when a module is imported: the first launch of a kernel builds it, and
``build_all`` builds every source in parallel (one nvcc each, all started
together), which is what chip_smoke.py does before anything else.

Every C entry takes pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("quant_matmul_int4", "quant_matmul_int8", "flash_decode", "flash_prefill",
           "paged_flash", "verify_prefix", "rms_norm", "flash_decode_tree", "paged_flash_tree")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
# C signatures: every entry returns the cudaError_t of its launches as int.
SIGNATURES = {
    "quant_matmul_int4": {
        # the decode body (M < 64): x, w, scale, workspace, counters, out, M,
        # K, N, ksplit, stream
        "qmm_int4": [P, P, P, P, P, P, I, I, I, I, P],
        # the tensor-core prefill path (M >= 64): x, w, scale, workspace,
        # out, M, K, N, ksplit, stream
        "qmm_int4_mma": [P, P, P, P, P, I, I, I, I, P],
        # the same two with an f32 output (the EmbedQuant4 tied head)
        "qmm_int4_f32": [P, P, P, P, P, P, I, I, I, I, P],
        "qmm_int4_mma_f32": [P, P, P, P, P, I, I, I, I, P],
    },
    "quant_matmul_int8": {
        # the arguments of qmm_int4 and qmm_int4_mma, w int8 [K, N]
        "qmm_int8": [P, P, P, P, P, P, I, I, I, I, P],
        "qmm_int8_mma": [P, P, P, P, P, I, I, I, I, P],
    },
    "flash_decode": {
        # q, k, v, positions, out, ws, counters, B, S, H, KVH, T, D, stride_kb,
        # stride_kh, scale, softcap, window, ring, nsplit, stream
        "flash_decode_bf16": [P, P, P, P, P, P, P, I, I, I, I, I, I, LL, LL, F, F, I, I, I, P],
        # q, k, v, k_scale, v_scale, positions, out, ws, counters, B, S, H, KVH,
        # T, D, stride_kb, stride_kh, stride_sb, stride_sh, scale, softcap,
        # window, ring, nsplit, stream
        "flash_decode_int8": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, LL, LL, LL, LL, F, F,
                              I, I, I, P],
    },
    "flash_decode_tree": {
        # q, k, v, bits, start, out, ws, counters, B, S, H,
        # KVH, T, D, stride_kb, stride_kh, scale, softcap, nsplit, stream
        "flash_decode_tree_bf16": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, LL, LL, F, F, I, P],
        # q, k, v, k_scale, v_scale, bits, start, out, ws, counters, B, S, H,
        # KVH, T, D, stride_kb, stride_kh, stride_sb, stride_sh, scale,
        # softcap, nsplit, stream
        "flash_decode_tree_int8": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, LL, LL, LL, LL,
                                   F, F, I, P],
    },
    "flash_prefill": {
        # q, k, v, positions, out, B, S, H, KVH, T, D, stride_kb, stride_kh,
        # scale, softcap, window, ring, stream
        "flash_prefill_bf16": [P, P, P, P, P, I, I, I, I, I, I, LL, LL, F, F, I, I, P],
        # q, k, v, k_scale, v_scale, positions, out, B, S, H, KVH, T, D,
        # stride_kb, stride_kh, stride_sb, stride_sh, scale, softcap, window,
        # ring, stream
        "flash_prefill_int8": [P, P, P, P, P, P, P, I, I, I, I, I, I, LL, LL, LL, LL, F, F, I, I,
                               P],
    },
    "paged_flash": {
        # q, k_pool, v_pool, table, positions, out, ws, counters, B, S, H, KVH,
        # M, P, D, stride_page, scale, softcap, window, nsplit, stream
        "paged_flash_bf16": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL, F, F, I, I, P],
        # q, k_pool, v_pool, k_scale, v_scale, table, positions, out, ws,
        # counters, B, S, H, KVH, M, P, D, stride_page, stride_spage, scale,
        # softcap, window, nsplit, stream
        "paged_flash_int8": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL, LL, F, F, I,
                             I, P],
    },
    "paged_flash_tree": {
        # q, k_pool, v_pool, table, bits, start, out, ws,
        # counters, B, S, H, KVH, M, P, D, stride_page, scale, softcap,
        # nsplit, stream
        "paged_flash_tree_bf16": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL, F, F, I, P],
        # q, k_pool, v_pool, k_scale, v_scale, table, bits, start, out, ws,
        # counters, B, S, H, KVH, M, P, D, stride_page, stride_spage, scale,
        # softcap, nsplit, stream
        "paged_flash_tree_int8": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL, LL, F,
                                  F, I, P],
    },
    "verify_prefix": {
        # draft, logits, ws, counters, mask, accept_len, B, K, V, row_stride,
        # batch_stride, nsplit, width, stream
        "verify_prefix_f32": [P, P, P, P, P, P, I, I, I, LL, LL, I, I, P],
    },
    "rms_norm": {
        # x, w, out, M, N, eps, one_offset, w_f32, stream
        "rms_norm_bf16": [P, P, P, I, I, F, I, I, P],
        # x, a, w, post_w, x_out, out, M, N, eps, one_offset, w_f32, stream
        "add_rms_norm_bf16": [P, P, P, P, P, P, I, I, F, I, I, P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # Headers are shared between sources: any header's bytes name every
    # library, so an edit to one never reuses a library built without it.
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library (for this source and these flags)
    is missing, in parallel; returns nvcc's -Xptxas -v report per built
    library. Raises with nvcc's output if any build fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Several processes (the ranks of a mesh) may reach an unbuilt library
    # at once: one builds under an exclusive lock on a file of BUILD_DIR,
    # the others wait and find it built.
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in todo if not _lib_path(n).exists()]
        return _build(todo) if todo else {}


def _build(todo: List[str]) -> Dict[str, str]:
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # Build to a temporary name of this process's own and rename, so a
        # build that is cut off never leaves a library that looks complete.
        tmp = _lib_path(name).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
        else:
            tmp.replace(_lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
