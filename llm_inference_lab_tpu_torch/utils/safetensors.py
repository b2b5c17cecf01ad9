"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length n, a JSON header of n
bytes, then the tensors' raw bytes (little-endian, row-major). The header
maps each tensor name to {"dtype", "shape", "data_offsets": [begin, end]}
(offsets into the byte buffer after the header) and may hold
"__metadata__", a map of strings to strings. The writer pads the header
with spaces to a multiple of 8 bytes and lays the tensors out in name
order with no gaps, as the `safetensors` package does, so each reads the
other's files.

``SafeFile`` reads lazily: opening a file reads its header only, and
``get`` reads one tensor's bytes into one host buffer, so a loader that
moves each tensor to the card before it reads the next holds at most one
tensor on the host.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "I8": torch.int8,
    "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_CODES = {dt: code for code, dt in DTYPES.items()}


class SafeFile:
    """One .safetensors file: ``keys()``, ``metadata()`` and ``get(name)``."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._meta = header.pop("__metadata__", None) or {}
        self._entries = header
        self._base = 8 + n

    def keys(self):
        return list(self._entries)

    def metadata(self) -> Dict[str, str]:
        return dict(self._meta)

    def get(self, name: str, device="cpu") -> torch.Tensor:
        e = self._entries[name]
        dtype = DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype {e['dtype']}, which this "
                             f"reader does not take ({sorted(DTYPES)})")
        begin, end = e["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self._base + begin)
            buf = bytearray(f.read(end - begin))
        if len(buf) != end - begin:
            raise ValueError(f"{self.path}: tensor {name!r} is cut short")
        flat = (torch.frombuffer(buf, dtype=dtype) if buf
                else torch.empty((0,), dtype=dtype))
        return flat.reshape(e["shape"]).to(device)


def shard_files(path: str):
    """The .safetensors files of `path`: the file itself, or every one in the
    directory, sorted by name."""
    if path.endswith(".safetensors"):
        return [path]
    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    return files


class Shards:
    """The tensors of a file or of a directory of shards, by name, read
    lazily: ``shards[name]`` reads one tensor (onto ``device``)."""

    def __init__(self, path: str, device="cpu"):
        self.device = device
        self._where: Dict[str, SafeFile] = {}
        for f in shard_files(path):
            sf = SafeFile(f)
            for k in sf.keys():
                self._where[k] = sf

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get(name, self.device)


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (name -> tensor on any device) to `path`."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors code here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
