"""Mixture-of-experts gated MLP (Mixtral's block).

Port of llm_inference_lab_tpu/ops/moe.py: top-k routing as ``_route`` (f32
router logits, the top k, a softmax over those k, HF Mixtral's weights) and
the exact expert MLP of ``moe_dense`` (every expert over every row, weighted
by the combine matrix; no capacity bound, no dropped token).

    moe_mlp(x [T, D], w_router [D, E], w_gate_up [E, D, 2F], w_down [E, F, D],
            top_k, act) -> [T, D] in x's dtype

Neither JAX implementation is a Pallas kernel: ``moe_ragged`` (the JAX
engine's default) is ``lax.ragged_dot`` over data-dependent group sizes,
``moe_dense`` einsums. The port keeps ``moe_dense``'s static shapes, which
a captured CUDA graph needs (a replay cannot read group sizes on the host),
and its products are ``torch.matmul`` over the expert axis. At a decode
step's few rows this reads all E experts' weights, E / top_k times what
the routed experts need (chip_smoke.py phase 19 prints both bounds).

Rounding: the gate-up product rounds to x's dtype (both JAX versions do),
the down product's [E, T, D] rows too (as ``moe_ragged``'s rows; ``moe_dense``
keeps them in f32), and the weighted sum over experts is f32, rounded once.
In f32 all three agree to the summation order.

``moe_expert`` is ``moe_dense``'s expert-parallel form, which JAX's engine
takes under an expert axis (GSPMD shards its [E, T, D] lanes on it): the
router and the combine weights whole on every rank, the rank's E / n
experts of the stacks, and under the model axis also its F / n columns of
each expert's gate and of its up (the fused [2F] leaf's two halves) and the
matching rows of w_down. Its experts' down products stay f32 (moe_dense's
ye), weighted in f32, and the rank's partial [T, D] is summed over the
expert group and the model group in f32 and rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llm_inference_lab_tpu_torch.ops.quant import f32_logits


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """(weights [T, k] f32, experts [T, k] int64): the router's f32 logits,
    the k largest (equal logits in ascending expert order, as lax.top_k
    breaks ties: a stable descending sort), and a softmax over those k."""
    logits = f32_logits(x, w_router.to(x.dtype).t())  # [T, E]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), idx[:, :top_k]


def gated(h: torch.Tensor, act: str) -> torch.Tensor:
    """A gated MLP's activation of its fused [..., 2F] gate|up product:
    silu (Llama) or tanh-gelu (Gemma's GeGLU) of the gate, times up."""
    f = h.shape[-1] // 2
    gate = F.silu(h[..., :f]) if act == "silu" else F.gelu(h[..., :f], approximate="tanh")
    return gate * h[..., f:]


def moe_mlp(x: torch.Tensor, w_router: torch.Tensor, w_gate_up: torch.Tensor,
            w_down: torch.Tensor, top_k: int = 2, act: str = "silu") -> torch.Tensor:
    E = w_gate_up.shape[0]
    weights, experts = route(x, w_router, top_k)
    # combine [T, E]: each token's routing weight of each expert (an expert
    # never repeats within a token's top k), zero where it is not routed.
    combine = torch.zeros((x.shape[0], E), dtype=torch.float32, device=x.device)
    combine.scatter_(1, experts, weights)
    xe = x[None] * (combine > 0).t()[..., None].to(x.dtype)  # [E, T, D]: routed rows
    h = gated(torch.matmul(xe, w_gate_up.to(x.dtype)), act)  # [E, T, F]
    ye = torch.matmul(h, w_down.to(x.dtype))  # [E, T, D]
    return torch.einsum("etd,te->td", ye.float(), combine).to(x.dtype)


def _f32_bmm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [E, T, F] @ w [E, F, D] with f32 products and sums, f32 out (JAX's
    preferred_element_type=f32): on the card one cuBLAS call an expert with
    an f32 output (f32_logits' aten::mm.dtype), on the CPU on f32 copies."""
    if not h.is_cuda:
        return torch.matmul(h.float(), w.float())
    return torch.stack([torch.mm(h[e], w[e], out_dtype=torch.float32)
                        for e in range(h.shape[0])])


def moe_expert(x: torch.Tensor, w_router: torch.Tensor, w_gate_up: torch.Tensor,
               w_down: torch.Tensor, top_k: int = 2, act: str = "silu", ep=None,
               tp=None) -> torch.Tensor:
    """JAX's moe_dense under an expert axis (ep, parallel/mesh.py AxisGroup:
    this rank holds experts [r E' / n, (r + 1) E' / n) of w_gate_up [E'/n, D,
    2F'] and w_down [E'/n, F', D], E' the experts padded to a multiple of n
    with zero experts the router never picks) and a model axis (tp: F' = F / m, the rank's
    gate and up columns and w_down rows). x [T, D] and w_router [D, E] are
    whole. The rank's experts' gated MLP over the rows routed to them, the
    down product in f32, weighted by the f32 combine; the partial sums added
    over both groups in f32, rounded to x's dtype once."""
    E = w_router.shape[-1]
    n_local = w_gate_up.shape[0]
    e0 = ep.rank * n_local if ep is not None else 0
    weights, experts = route(x, w_router, top_k)
    combine = torch.zeros((x.shape[0], E), dtype=torch.float32, device=x.device)
    combine.scatter_(1, experts, weights)
    # This rank's experts; a padded expert (past the router's E columns,
    # parallel/sharding.py) has a zero column: never routed.
    combine = F.pad(combine, (0, max(0, e0 + n_local - E)))[:, e0:e0 + n_local]
    xe = x[None] * (combine > 0).t()[..., None].to(x.dtype)  # [E/n, T, D]: routed rows
    h = gated(torch.matmul(xe, w_gate_up.to(x.dtype)), act)  # [E/n, T, F']
    ye = _f32_bmm(h, w_down.to(x.dtype))  # [E/n, T, D] f32
    y = torch.einsum("etd,te->td", ye, combine)
    for group in (ep, tp):
        if group is not None:
            y = group.all_reduce(y)
    return y.to(x.dtype)
