"""Weight-only quantization (INT8 / INT4) and the ``dense`` entry point.

Port of llm_inference_lab_tpu/ops/quant.py with the same formats and bytes:

* INT8: symmetric per-output-channel scales, ``w ~ q * scale[None, :]``.
* INT4 "v2 split-K halves": byte ``[i, n]`` holds row i in its low nibble,
  biased by +8, and row ``i + K/2`` in its high nibble as two's complement.
* EmbedQuant: int8 embedding table ``[V, D]`` with per-row scales, used both
  for the lookup and as the tied lm_head (f32 logits).

Layer-stacked weights (``data [L, K/2, N]``, ``scale [L, N]``) need no
QuantStackRef: ``QuantTensor.layer(i)`` is a view into the stacked buffer,
and the kernel reads it through its pointer offset with no copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul, unpack_int4


@dataclass
class QuantTensor:
    """Quantized weight, logical shape [d_in, d_out] (or [L, d_in, d_out]).

    data:  int8 [.., d_in, d_out] (int8) or [.., d_in // 2, d_out] (packed int4)
    scale: float32 [.., d_out]
    """

    data: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    @property
    def shape(self):
        if self.bits == 4:
            return (*self.data.shape[:-2], self.data.shape[-2] * 2, self.data.shape[-1])
        return tuple(self.data.shape)

    def layer(self, i: int) -> "QuantTensor":
        """Layer i of a stacked weight: views, no copy."""
        return QuantTensor(self.data[i], self.scale[i], self.bits)


def quantize_int8(w: torch.Tensor) -> QuantTensor:
    """Symmetric per-output-channel int8 quantization of [d_in, d_out]."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2).clamp_min(1e-8) / 127.0
    q = torch.round(w32 / scale.unsqueeze(-2)).clamp(-127, 127).to(torch.int8)
    return QuantTensor(q, scale, bits=8)


def quantize_int4(w: torch.Tensor) -> QuantTensor:
    """Symmetric per-output-channel int4, v2 split-K-halves packing."""
    d_in = w.shape[-2]
    if d_in % 2:
        raise ValueError("int4 packing requires an even d_in")
    w32 = w.float()
    scale = w32.abs().amax(dim=-2).clamp_min(1e-8) / 7.0
    q = torch.round(w32 / scale.unsqueeze(-2)).clamp(-7, 7).to(torch.int32)
    half = d_in // 2
    lo, hi = q[..., :half, :], q[..., half:, :]
    packed = (((lo + 8) & 0x0F) | ((hi & 0x0F) << 4)).to(torch.int8)
    return QuantTensor(packed, scale, bits=4)


def quantize(w: torch.Tensor, mode: str) -> QuantTensor:
    if mode == "int8":
        return quantize_int8(w)
    if mode == "int4":
        return quantize_int4(w)
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    return (q.float() * qt.scale.unsqueeze(-2)).to(dtype)


def quant_matmul_plain_int8(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """(x @ q) * scale with f32 accumulation, output in x's dtype (the int8
    counterpart of quant_matmul_xla; its Hopper kernel is queued)."""
    y = torch.matmul(x.float(), qt.data.float()) * qt.scale
    return y.to(x.dtype)


@dataclass
class EmbedQuant:
    """Quantized embedding table [V, D] with per-row (per-token) scales [V]:
    the lookup table and the tied lm_head."""

    q: torch.Tensor  # int8 [V, D]
    scale: torch.Tensor  # f32 [V]

    def lookup(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        rows = self.q[tokens].float()
        return (rows * self.scale[tokens].unsqueeze(-1)).to(dtype)

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        # x [.., D] @ q[V, D]^T with the row scales on the vocab axis. The
        # int8 -> x.dtype cast materializes a copy of the table every call
        # (788 MB at bf16 for the 3B head); routing the head through an int8
        # kernel is queued.
        y = torch.matmul(x, self.q.to(x.dtype).t())
        return y.float() * self.scale


def quantize_embed(embed: torch.Tensor) -> EmbedQuant:
    e32 = embed.float()
    scale = e32.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.round(e32 / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return EmbedQuant(q, scale)


def dense(x: torch.Tensor, w: Any) -> torch.Tensor:
    """The single matmul entry point for all model projections.

    x: [..., d_in]; w: tensor [d_in, d_out] or a (per-layer) QuantTensor.
    int4 weights go through quant_matmul (the kernel on CUDA tensors)."""
    if not isinstance(w, QuantTensor):
        return torch.matmul(x, w.to(x.dtype))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if w.bits == 4:
        y = quant_matmul(x2, w.data, w.scale)
    elif x.is_cuda:
        raise NotImplementedError("int8 weights on CUDA need the int8 kernel (queued)")
    else:
        y = quant_matmul_plain_int8(x2, w)
    return y.reshape(*lead, w.shape[-1])


def quantize_params(params: Any, mode: str, min_size: int = 1 << 16,
                    include_embed: bool = False) -> Any:
    """Quantize every 2-D/3-D weight leaf >= min_size elements (norms and the
    embedding stay as they are unless include_embed, which makes the
    embedding an int8 EmbedQuant). Leaves are replaced in place in the
    nested dict."""

    def walk(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            for key in list(node.keys()):
                node[key] = walk(node[key], f"{prefix}.{key}")
            return node
        if not isinstance(node, torch.Tensor):
            return node
        if prefix.endswith(".embed"):
            return quantize_embed(node) if include_embed else node
        if "embed" in prefix or "norm" in prefix or "bias" in prefix:
            return node
        if node.dim() in (2, 3) and node.numel() >= min_size:
            return quantize(node, mode)
        return node

    return walk(params, "")
