"""Weight-only quantization (INT8 / INT4) and the ``dense`` entry point.

Port of llm_inference_lab_tpu/ops/quant.py with the same formats and bytes:

* INT8: symmetric per-output-channel scales, ``w ~ q * scale[None, :]``.
* INT4 "v2 split-K halves": byte ``[i, n]`` holds row i in its low nibble,
  biased by +8, and row ``i + K/2`` in its high nibble as two's complement.
* EmbedQuant: int8 embedding table ``[V, D]`` with per-row scales, used both
  for the lookup and as the tied lm_head (f32 logits).
* EmbedQuant4: the same values at int4 in two layouts, the head's packed
  ``[D/2, V]`` (kernel A's operand, through its f32-output instantiation)
  and the lookup's row-packed ``[V, D/2]``.

Layer-stacked weights (``data [L, K/2, N]``, ``scale [L, N]``) need no
QuantStackRef: ``QuantTensor.layer(i)`` is a view into the stacked buffer,
and the kernel reads it through its pointer offset with no copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from llm_inference_lab_tpu_torch.ops.quant_matmul import (
    quant_matmul,
    quant_matmul_f32,
    quant_matmul_int8,
    unpack_int4,
)


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
    q = torch.round(w32 / scale.unsqueeze(-2)).clamp(-7, 7)
    return QuantTensor(pack_int4(q), scale, bits=4)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values [.., K, N] (in [-8, 7]) -> the v2 packing [.., K/2, N]:
    byte [i, n] holds row i + 8 in its low nibble and row i + K/2 in its
    high nibble."""
    q = q.to(torch.int32)
    half = q.shape[-2] // 2
    lo, hi = q[..., :half, :], q[..., half:, :]
    return (((lo + 8) & 0x0F) | ((hi & 0x0F) << 4)).to(torch.int8)


def quantize(w: torch.Tensor, mode: str) -> QuantTensor:
    if mode == "int8":
        return quantize_int8(w)
    if mode == "int4":
        return quantize_int4(w)
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    return (q.float() * qt.scale.unsqueeze(-2)).to(dtype)


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
        # x [.., D] @ q[V, D]^T in f32, then the row scales on the vocab axis
        # in f32, as JAX's dot_general with preferred_element_type=f32. The
        # int8 -> x.dtype cast materializes a copy of the table every call
        # (788 MB at bf16 for the 3B head); routing the head through an int8
        # kernel is queued.
        return f32_logits(x, self.q.to(x.dtype)) * self.scale


def f32_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [.., D] @ table[V, D]^T with f32 products and f32 sums, f32 out: the
    head's logits as JAX computes them (preferred_element_type=f32), never
    rounded to x's dtype. On the card one cuBLAS call with an f32 output
    (aten::mm.dtype); that overload has no CPU kernel, so on the CPU the
    product runs on f32 copies (a product of two bf16 values is exact in
    f32)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2, table.t(), out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), table.float().t())
    return y.reshape(*lead, table.shape[0])


@dataclass
class EmbedQuant4:
    """INT4 embedding table and tied head (EngineConfig.embed_bits=4; JAX
    ops/quant.py EmbedQuant4): one set of int4 values in two packings.

    qt: the head layout, a QuantTensor of packed [D/2, V] (v2 split-K
    halves) with the per-token scales [V] on its output axis: kernel A's
    operand, so the head reads half the int8 table's bytes in place (no
    copy of the table a call). rq: the row layout int8 [V, D/2], byte j of
    row v holding w[v, j] + 8 in its low nibble and w[v, j + D/2] in its
    high nibble, so the lookup gathers contiguous rows."""

    qt: QuantTensor  # bits 4, data [D/2, V], scale [V]
    rq: torch.Tensor  # int8 [V, D/2]

    @property
    def shape(self):  # logical [V, D], as a bf16 table's
        return (self.qt.data.shape[1], self.qt.data.shape[0] * 2)

    def lookup(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The rows of `tokens` [..] -> [.., D] in dtype (plain torch on the
        device, as JAX's is XLA): the gathered bytes unpacked, times the
        row's scale in f32."""
        b = self.rq[tokens]
        t = b & 0x0F  # the low nibble, biased by +8
        lo = (t - 8).float()
        # byte = 16 h + (l + 8), so (byte - t) is 16 h: an exact shift.
        hi = ((b.to(torch.int32) - t.to(torch.int32)) >> 4).float()
        rows = torch.cat([lo, hi], dim=-1)
        return (rows * self.qt.scale[tokens].unsqueeze(-1)).to(dtype)

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [.., D] -> f32 logits [.., V]: kernel A's f32 instantiation
        (JAX's dense rounds them to bf16; the port keeps f32)."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return quant_matmul_f32(x2, self.qt.data, self.qt.scale).reshape(*lead, -1)


def repack_int4_rows(qt_data: torch.Tensor) -> torch.Tensor:
    """Head layout packed [D/2, V] -> row layout packed [V, D/2] of the same
    int4 values (JAX repack_int4_rows, byte for byte)."""
    t = (qt_data & 0x0F).to(torch.int32)  # biased low nibbles
    lo = t - 8  # rows [0, D/2)
    hi = (qt_data.to(torch.int32) - t) >> 4  # rows [D/2, D)
    return (((lo.t() + 8) & 0x0F) | ((hi.t() & 0x0F) << 4)).to(torch.int8).contiguous()


def quantize_embed4(embed: torch.Tensor) -> EmbedQuant4:
    """[V, D] table -> EmbedQuant4: int4 quantization of the transpose
    (each token row's scale on the head's output axis), and the row layout
    repacked from the same bytes (JAX quantize_embed4)."""
    qt = quantize_int4(embed.float().t().contiguous())
    qt = QuantTensor(qt.data.contiguous(), qt.scale.contiguous(), bits=4)
    return EmbedQuant4(qt, repack_int4_rows(qt.data))


def quantize_embed(embed: torch.Tensor) -> EmbedQuant:
    e32 = embed.float()
    scale = e32.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.round(e32 / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return EmbedQuant(q, scale)


def int4_rows(data: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of the int4 weight packed in data [.., K/2, N], as int8
    values in [-8, 7]: rows below K/2 are the low nibbles of the packed rows
    of the same index, rows from K/2 the high nibbles of row - K/2. Only
    those packed rows are read."""
    half = data.shape[-2]
    parts = []
    if r0 < half:
        parts.append((data[..., r0:min(r1, half), :] & 0x0F) - 8)
    if r1 > half:
        parts.append(data[..., max(r0, half) - half:r1 - half, :] >> 4)
    return torch.cat(parts, dim=-2)


def row_shard(w: "QuantTensor", r0: int, r1: int) -> "QuantTensor":
    """Rows [r0, r1) of a quantized weight [.., K, N] (its input dim: a
    row-parallel projection's shard), a contiguous copy. int8 slices its
    rows; int4 cannot slice bytes (byte [i, n] holds rows i and i + K/2), so
    its rows are unpacked and packed again at K' = r1 - r0 (int4_rows,
    pack_int4). The per-output-channel scale stays whole: every shard's
    partial sums of a column take the column's scale."""
    if w.bits == 4:
        if (r1 - r0) % 2:
            raise ValueError(f"an int4 row shard needs an even row count, got {r1 - r0}")
        data = pack_int4(int4_rows(w.data, r0, r1))
    else:
        data = w.data[..., r0:r1, :]
    return QuantTensor(data.contiguous(), w.scale.clone(), w.bits)


def column_shard(w: Any, cols: torch.Tensor) -> Any:
    """Output columns `cols` (an index tensor) of a weight [.., K, N] or a
    bias [.., N]: a QuantTensor's bytes and scales, each a contiguous copy
    (kernel A's wrapper takes contiguous, 16-byte aligned operands, and a
    view would keep the whole tensor alive)."""
    if isinstance(w, QuantTensor):
        return QuantTensor(w.data.index_select(-1, cols).contiguous(),
                           w.scale.index_select(-1, cols).contiguous(), w.bits)
    return w.index_select(-1, cols).contiguous()


def vocab_shard(embed: Any, v0: int, v1: int) -> Any:
    """Vocab rows [v0, v1) of an embedding: a table [V, D]'s rows, an
    EmbedQuant's rows and scales, an EmbedQuant4's head-layout columns,
    row-layout rows and scales; each a contiguous copy."""
    if isinstance(embed, EmbedQuant):
        return EmbedQuant(embed.q[v0:v1].contiguous(), embed.scale[v0:v1].contiguous())
    if isinstance(embed, EmbedQuant4):
        return EmbedQuant4(QuantTensor(embed.qt.data[:, v0:v1].contiguous(),
                                       embed.qt.scale[v0:v1].contiguous(), bits=4),
                           embed.rq[v0:v1].contiguous())
    return embed[v0:v1].contiguous()


def dense_f32(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., d_in] @ w with an f32 output (no bias): a row-parallel
    projection's partial sum, which the ranks add in f32 before the sum is
    rounded once (models/transformer.py). int4 through kernel A's f32
    instantiation (quant_matmul_f32); int8 through kernel B, which has no
    f32 instantiation: its partial is rounded to x's dtype first (at bf16,
    2^-9 of each partial's magnitude); an unquantized weight with f32
    products and sums (f32_logits' route)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if isinstance(w, QuantTensor):
        if w.bits == 4:
            y = quant_matmul_f32(x2, w.data, w.scale)
        else:
            y = quant_matmul_int8(x2, w.data, w.scale).float()
    else:
        y = f32_logits(x2, w.to(x.dtype).t())
    return y.reshape(*lead, y.shape[-1])


def dense(x: torch.Tensor, w: Any, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The single matmul entry point for all model projections.

    x: [..., d_in]; w: tensor [d_in, d_out] or a (per-layer) QuantTensor;
    b: an optional bias [d_out], added after the product is rounded to x's
    dtype (as JAX's dense adds it). int4 weights go through quant_matmul
    (kernel A on CUDA tensors), int8 weights through quant_matmul_int8
    (kernel B)."""
    if not isinstance(w, QuantTensor):
        y = torch.matmul(x, w.to(x.dtype))
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        matmul = quant_matmul if w.bits == 4 else quant_matmul_int8
        y = matmul(x2, w.data, w.scale).reshape(*lead, w.shape[-1])
    return y if b is None else y + b.to(y.dtype)


# The projections' bias leaves (Qwen2's b_qkv; GPT-2's and OPT's four).
BIASES = ("b_qkv", "bo", "b_fc", "b_proj")


def quantize_params(params: Any, mode: str, min_size: int = 1 << 16,
                    include_embed: bool = False, embed_bits: int = 8) -> Any:
    """Quantize every 2-D/3-D weight leaf >= min_size elements (norms and the
    embedding stay as they are unless include_embed, which makes the
    embedding an int8 EmbedQuant, or with embed_bits 4 an EmbedQuant4).
    Biases stay too: JAX's quantize_params
    tells them by "bias" in the name, which its stacked bias leaves (b_qkv,
    bo, b_fc, b_proj) lack, so it quantizes one of them from min_size
    elements (qwen2.5-7b's b_qkv, [28, 4608]) and its dense then fails on
    it. Leaves are replaced in place in the nested dict."""

    def walk(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            for key in list(node.keys()):
                node[key] = walk(node[key], f"{prefix}.{key}")
            return node
        if not isinstance(node, torch.Tensor):
            return node
        if prefix.endswith(".embed"):
            if not include_embed:
                return node
            return quantize_embed4(node) if embed_bits == 4 else quantize_embed(node)
        if ("embed" in prefix or "norm" in prefix or "bias" in prefix
                or prefix.rsplit(".", 1)[-1] in BIASES):
            return node
        if node.dim() in (2, 3) and node.numel() >= min_size:
            return quantize(node, mode)
        return node

    return walk(params, "")
