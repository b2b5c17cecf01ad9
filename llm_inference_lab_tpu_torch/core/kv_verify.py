"""KV-cache alignment check: the live cache against a fresh prefill.

Port of llm_inference_lab_tpu/core/kv_verify.py (``compute_kv_checksum``
and ``kv_alignment_report``). The cache invariant is structural (slot ==
absolute position, rows [0, L-1) committed), so one check after a
generation suffices: re-prefill the committed tokens from scratch with the
same model and compare the caches row by row under the length mask, int8
caches dequantized. A rolling-buffer cache holds only its last ring_len
rows, so slot == position fails there: its report says it was skipped, as
in JAX. It is a plain function the caller invokes on a final
state (``Engine.decode`` returns one); the JAX package gates it behind an
environment flag, the port has none.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from llm_inference_lab_tpu_torch.core.state import DecodeState
from llm_inference_lab_tpu_torch.models.base import KVCache, Model
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache, gather_pages


def _dequant(vals: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """[L, B, H, T, D] int8 or float + [L, B, H, T] scales -> f32 values."""
    v = vals.float()
    if vals.dtype == torch.int8:
        v = v * scale[..., None]
    return v


def _committed_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[1, B, 1, T, 1]: rows [0, L-1) of each sequence."""
    rows = torch.arange(T, device=lengths.device)[None, :] < (lengths - 1).clamp_min(0)[:, None]
    return rows[None, :, None, :, None]


def compute_kv_checksum(cache: KVCache, lengths: torch.Tensor) -> float:
    """Sum of |k| and |v| over the committed rows [0, L-1) of every
    sequence, f32, int8 caches dequantized."""
    m = _committed_mask(lengths, cache.max_seq_len).float()
    k = _dequant(cache.k, cache.k_scale)
    v = _dequant(cache.v, cache.v_scale)
    return float((k.abs() * m).sum() + (v.abs() * m).sum())


def _contiguous(cache: PagedKVCache, T: int) -> KVCache:
    """The first T positions of every sequence of a paged cache, gathered
    through its table into a contiguous KVCache."""
    def gather(pool):
        if pool is None:
            return None
        return torch.stack([gather_pages(layer, cache.table)[:, :, :T] for layer in pool])

    return KVCache(gather(cache.k), gather(cache.v), gather(cache.k_scale), gather(cache.v_scale))


@torch.inference_mode()
def kv_alignment_report(model: Model, state: DecodeState, atol: float = 5e-2,
                        rtol: float = 5e-2) -> Dict[str, Any]:
    """Compare the target cache of `state` against a prefill of its
    committed tokens into a fresh cache of the same element type.

    Committed rows agree up to the rounding of a chunked forward against a
    single one. The difference of each element is taken relative to
    max(|fresh|, 1); the report is aligned when the largest is at most
    max(atol, rtol), as in the JAX package."""
    if model.config.kv_ring_len is not None:
        return {"aligned": True, "skipped": "kv_ring"}
    tokens, lengths = state.tokens, state.lengths
    B, T = tokens.shape
    live = state.target_cache
    if isinstance(live, PagedKVCache):
        live = _contiguous(live, T)
    fresh = model.init_cache(B, T, tokens.device, dtype=live.k.dtype)
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[None].repeat(B, 1)
    model.forward(tokens, positions, fresh, torch.zeros((B,), dtype=torch.int32,
                                                        device=tokens.device))
    mask = _committed_mask(lengths, T)
    report: Dict[str, Any] = {}
    aligned = True
    for name, live_c, fresh_c, live_s, fresh_s in (
            ("k", live.k, fresh.k, live.k_scale, fresh.k_scale),
            ("v", live.v, fresh.v, live.v_scale, fresh.v_scale)):
        a, b = _dequant(live_c, live_s), _dequant(fresh_c, fresh_s)
        d = torch.where(mask, (a - b).abs() / b.abs().clamp_min(1.0), 0.0)
        mx = float(d.max())
        report[f"max_rel_diff_{name}"] = mx
        aligned = aligned and mx <= max(atol, rtol)
    return {
        "aligned": bool(aligned),
        **report,
        "checksum_live": compute_kv_checksum(live, lengths),
        "checksum_fresh": compute_kv_checksum(fresh, lengths),
        "committed_rows": int((lengths - 1).clamp_min(0).sum()),
    }
