"""The port's own checkpoints: a param tree saved to one .safetensors file
and loaded back, quantization included.

Port of llm_inference_lab_tpu/models/checkpoint.py, with its names, so
the two packages read each other's files: nested-dict paths joined with
'/'; a QuantTensor leaf as '<path>/__qdata__' and '<path>/__qscale__' with
its bit width in the metadata's "quant" (JSON, path -> bits); an
EmbedQuant leaf as '<path>/__edata__' and '<path>/__escale__'; the metadata's
"int4_fmt" is "v2" (int4 bytes: the low nibble biased by +8, the high
nibble two's complement). A file without that marker is v1, whose low
nibble was two's complement too: loading migrates its int4 bytes with one
XOR of bit 3. An EmbedQuant4 leaf is saved as its head layout,
'<path>/__e4data__' and '<path>/__e4scale__'; its row layout is repacked on
load. JAX's migration keys on '__qdata__' only, so it would load an
'__e4data__' leaf of a v1 file unmigrated: the port refuses one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from llm_inference_lab_tpu_torch.ops.quant import (
    EmbedQuant,
    EmbedQuant4,
    QuantTensor,
    repack_int4_rows,
)
from llm_inference_lab_tpu_torch.utils.safetensors import SafeFile, save_file

_QDATA, _QSCALE = "/__qdata__", "/__qscale__"
_EDATA, _ESCALE = "/__edata__", "/__escale__"
_E4DATA, _E4SCALE = "/__e4data__", "/__e4scale__"


def save_params(params: Any, path: str) -> None:
    """Write the param tree (tensors, QuantTensor, EmbedQuant and EmbedQuant4
    leaves, on any device) to `path`."""
    tensors: Dict[str, torch.Tensor] = {}
    quant: Dict[str, int] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, QuantTensor):
            tensors[prefix + _QDATA], tensors[prefix + _QSCALE] = node.data, node.scale
            quant[prefix] = node.bits
        elif isinstance(node, EmbedQuant):
            tensors[prefix + _EDATA], tensors[prefix + _ESCALE] = node.q, node.scale
        elif isinstance(node, EmbedQuant4):  # the row layout is derived: not saved
            tensors[prefix + _E4DATA], tensors[prefix + _E4SCALE] = node.qt.data, node.qt.scale
        else:
            tensors[prefix] = node

    walk(params, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(tensors, path, metadata={"quant": json.dumps(quant), "int4_fmt": "v2"})


def load_params(path: str, dtype: Optional[torch.dtype] = None, device="cpu") -> Any:
    """The param tree of `path` on `device`, QuantTensor leaves with their
    recorded bit width (v1 int4 bytes migrated to v2); `dtype` casts the
    floating-point plain leaves."""
    f = SafeFile(path)
    meta = f.metadata()
    quant = json.loads(meta.get("quant", "{}"))
    v1 = meta.get("int4_fmt") != "v2"
    out: Dict[str, Any] = {}

    def put(base: str, value: Any) -> None:
        keys = base.split("/")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    names = f.keys()
    for name in names:
        if v1 and name.endswith(_E4DATA):
            raise ValueError(
                f"{path}: {name.rsplit('/__', 1)[0]} is an int4 embedding (EmbedQuant4) in a "
                "v1 file (no int4_fmt marker): its nibbles' format is not known")
    for name in names:
        base, _, tag = name.rpartition("/__")
        tag = "/__" + tag if base else ""
        if tag == _QDATA:
            bits = int(quant.get(base, 8))
            data = f.get(name, device)
            if v1 and bits == 4:
                data = data ^ 0x08  # v1 -> v2: the low nibble's sign bit
            put(base, QuantTensor(data, f.get(base + _QSCALE, device), bits))
        elif tag == _EDATA:
            put(base, EmbedQuant(f.get(name, device), f.get(base + _ESCALE, device)))
        elif tag == _E4DATA:
            data = f.get(name, device)
            put(base, EmbedQuant4(QuantTensor(data, f.get(base + _E4SCALE, device), bits=4),
                                  repack_int4_rows(data)))
        elif tag in (_QSCALE, _ESCALE, _E4SCALE):
            continue  # read with its data
        else:
            t = f.get(name, device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            put(name, t)
    return out
