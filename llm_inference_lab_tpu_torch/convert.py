"""Carry the JAX package's parameters over to the port, bytes unchanged.

``params_from_jax`` walks a nested dict of arrays (numpy or anything
``np.asarray`` reads, including the JAX package's own arrays) whose
quantized leaves are objects with ``data``, ``scale`` and ``bits``
attributes (QuantTensor), ``q`` and ``scale`` (EmbedQuant) or ``qt`` and
``rq`` (EmbedQuant4, both layouts), and returns
the port's param tree with the same layout: stacked ``[L, ...]`` layer
leaves, v2 split-K-halves int4 bytes, per-channel and per-row scales. Both
sides then compute with the same weights. The JAX engine's Medusa heads
(``Engine._draft_params``, ``{"medusa_proj": [H, D, D]}``) carry over the
same way, for the port's ``Engine(..., draft_params=...)`` in the medusa
and tree modes, and so does a LoRA pack in the layers (``lora_A_<site>``,
``lora_B_<site>``, plain arrays). Duck typing keeps the port free
of any import of JAX or of the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, EmbedQuant4, QuantTensor


def to_tensor(a: Any, device="cpu") -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "qt") and hasattr(tree, "rq"):
        return EmbedQuant4(params_from_jax(tree.qt, device), to_tensor(tree.rq, device))
    if all(hasattr(tree, a) for a in ("data", "scale", "bits")):
        return QuantTensor(to_tensor(tree.data, device), to_tensor(tree.scale, device),
                           int(tree.bits))
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return EmbedQuant(to_tensor(tree.q, device), to_tensor(tree.scale, device))
    return to_tensor(tree, device)
