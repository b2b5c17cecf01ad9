"""Build the CUDA kernels under csrc/ with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (nvcc for sm_90a, -O3, -shared, -fPIC), where
the hash covers the source and NVCC_FLAGS: a changed source or changed flags
name a library that does not exist yet, so it is built afresh. Nothing is
built when a module is imported: the first launch of a kernel builds it, and
``build_all`` builds every source in parallel (one nvcc each, all started
together), which is what chip_smoke.py does before anything else.

Every C entry takes pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("quant_matmul_int4", "flash_decode", "verify_prefix")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int
# C signatures: every entry returns the cudaError_t of its launches as int.
SIGNATURES = {
    "quant_matmul_int4": {
        # x, w, scale, workspace, out, M, K, N, ksplit, stream
        "qmm_int4": [P, P, P, P, P, I, I, I, I, P],
    },
    "flash_decode": {
        # q, k, v, positions, out, B, S, H, KVH, T, D, stride_kb, stride_kh,
        # scale, stream
        "flash_decode_bf16": [P, P, P, P, P, I, I, I, I, I, I, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_float, P],
    },
    "verify_prefix": {
        # draft, logits, arg_ws, mask, accept_len, B, K, V, row_stride, batch_stride, stream
        "verify_prefix_f32": [P, P, P, P, P, I, I, I, ctypes.c_longlong,
                              ctypes.c_longlong, P],
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
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # Build to a temporary name and rename, so a build that is cut off
        # never leaves a library that looks complete.
        tmp = _lib_path(name).with_suffix(".so.tmp")
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
