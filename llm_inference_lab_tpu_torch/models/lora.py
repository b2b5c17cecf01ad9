"""Multi-LoRA serving: per-slot low-rank adapters over one base model.

Port of llm_inference_lab_tpu/models/lora.py. Every adapter lives stacked
on the device, per target site A [L, n, d_in, R] and B [L, n, R, d_out]
(layer-major: the pack rides ``params["layers"]`` and a layer takes its
slice as a view), and each row of a batch adds the delta of its slot's
adapter, ``lora_ids[b]``, -1 being the base model (an exact zero delta).

Sites, at the fused projections of models/transformer.py: ``qkv`` (the
per-matrix q/k/v pairs fused block-diagonally into one pair of rank 3R,
whose product equals the three deltas), ``o``, ``gate_up`` (gate and up
fused the same way) and ``down``. The MLP sites exist only for a gated MLP:
JAX's forward returns from a MoE, GPT-2 or OPT MLP before it adds them, so
an adapter's gate/up/down matrices would be dropped there with no error;
``build_pack`` refuses them instead.

The delta is plain torch (JAX's is two XLA einsums; no Pallas kernel).
JAX gathers each row's adapter, ``A[lora_ids]``, a copy of the pack a row
every layer (at 8 slots of one rank-16 3B adapter, 8 x 72.5 MB read and
written a forward). Here a site reads its layer's pack once: x times every
adapter's A (one batched product, [n, rows, R]), each row's own adapter
kept by a 0/1 mask (built once a forward, ``adapter_mask``), then one
product with every adapter's B flattened to [n R, d_out]. Bytes a forward:
the pack once (n x 72.5 MB at rank 16 on the 3B) and rows x n x R
intermediates.

PEFT directories (adapter_config.json + adapter_model.safetensors) load
with ``load_peft_adapter``, through the port's own safetensors reader.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llm_inference_lab_tpu_torch.models.base import ModelConfig
from llm_inference_lab_tpu_torch.utils.safetensors import SafeFile

SITES = ("qkv", "o", "gate_up", "down")
MLP_SITES = ("gate_up", "down")


def _site_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {"qkv": (D, (H + 2 * KV) * Dh), "o": (H * Dh, D), "gate_up": (D, 2 * cfg.d_ff),
            "down": (cfg.d_ff, D)}


def _matrix_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {"q": (D, H * Dh), "k": (D, KV * Dh), "v": (D, KV * Dh), "o": (H * Dh, D),
            "gate": (D, cfg.d_ff), "up": (D, cfg.d_ff), "down": (cfg.d_ff, D)}


def _fuse_block_diag(parts, in_dim: int, out_slices, rank: int):
    """Per-matrix (A [in, r], B [r, out_i]) pairs (None: not adapted) fused
    into ONE pair whose product equals the per-matrix deltas: A_f the A_i
    side by side on the rank axis, B_f each B_i at its output slice, block
    diagonally."""
    total_r = rank * len(parts)
    A = np.zeros((in_dim, total_r), np.float32)
    B = np.zeros((total_r, out_slices[-1][1]), np.float32)
    for i, (ab, (lo, hi)) in enumerate(zip(parts, out_slices)):
        if ab is None:
            continue
        a, b = ab
        r = a.shape[1]
        A[:, i * rank: i * rank + r] = a
        B[i * rank: i * rank + r, lo:hi] = b
    return A, B


class Adapter:
    """One adapter's per-layer, per-site pairs (numpy f32, the scaling alpha
    / rank folded into B): weights[site] = (A [L, in, R], B [L, R, out]) or
    None."""

    def __init__(self, name: str, weights: Dict[str, Any]):
        self.name = name
        self.weights = weights


def make_adapter(cfg: ModelConfig, name: str, rank: int = 8, alpha: float = 16.0,
                 targets: tuple = ("q", "v"), rng: Optional[np.random.Generator] = None,
                 matrices: Optional[Dict[str, tuple]] = None) -> Adapter:
    """An adapter from per-matrix (A [L, in, r], B [L, r, out]) numpy pairs
    keyed q/k/v/o/gate/up/down (a missing key is not adapted), or, when
    matrices is None, a random one on `targets` (A and B ~ N(0, 0.02^2) from
    rng, so the delta is not zero, as JAX's make_adapter draws them). The
    scaling alpha / rank is folded into B."""
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = cfg.n_layers
    scale = alpha / rank
    if matrices is None:
        rng = rng or np.random.default_rng(0)
        dims = _matrix_dims(cfg)
        matrices = {}
        for t in targets:
            di, do = dims[t]
            matrices[t] = (rng.normal(0, 0.02, (L, di, rank)).astype(np.float32),
                           rng.normal(0, 0.02, (L, rank, do)).astype(np.float32))

    def per_layer(t, i):
        m = matrices.get(t)
        return None if m is None else (m[0][i], m[1][i] * scale)

    dims = _site_dims(cfg)
    qs = [(0, H * Dh), (H * Dh, (H + KV) * Dh), ((H + KV) * Dh, (H + 2 * KV) * Dh)]
    gs = [(0, cfg.d_ff), (cfg.d_ff, 2 * cfg.d_ff)]
    weights: Dict[str, Any] = {}
    for site, keys, slices in (("qkv", ("q", "k", "v"), qs), ("gate_up", ("gate", "up"), gs)):
        if not any(k in matrices for k in keys):
            weights[site] = None
            continue
        pairs = [_fuse_block_diag([per_layer(k, i) for k in keys], dims[site][0], slices, rank)
                 for i in range(L)]
        weights[site] = (np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs]))
    for site in ("o", "down"):
        weights[site] = ((matrices[site][0], matrices[site][1] * scale) if site in matrices
                         else None)
    return Adapter(name, weights)


def build_pack(cfg: ModelConfig, adapters: List[Adapter], dtype=torch.bfloat16,
               device="cpu"):
    """The adapters stacked for params["layers"]: per site with any adapter
    on it, lora_A_<site> [L, n, in, R_max] and lora_B_<site> [L, n, R_max,
    out] in dtype (ranks zero-padded, a site an adapter lacks all zeros), and
    the name -> index map. JAX's build_pack, leaf for leaf. Raises
    ValueError for MLP matrices on a model without a gated MLP (Mixtral's
    experts, GPT-2's and OPT's plain MLP), where JAX drops them."""
    if cfg.moe or not cfg.gated_mlp:
        for a in adapters:
            if any(a.weights.get(site) is not None for site in MLP_SITES):
                kind = "a MoE" if cfg.moe else "a plain (not gated)"
                raise ValueError(f"LoRA adapter {a.name!r} adapts gate/up/down, which {kind} "
                                 "MLP does not have: only q, k, v and o can be adapted here")
    dims = _site_dims(cfg)
    L, n = cfg.n_layers, len(adapters)
    pack: Dict[str, torch.Tensor] = {}
    for site in SITES:
        ranks = [a.weights[site][0].shape[-1] for a in adapters
                 if a.weights.get(site) is not None]
        if not ranks:
            continue
        R = max(ranks)
        di, do = dims[site]
        A = np.zeros((L, n, di, R), np.float32)
        B = np.zeros((L, n, R, do), np.float32)
        for j, a in enumerate(adapters):
            w = a.weights.get(site)
            if w is None:
                continue
            r = w[0].shape[-1]
            A[:, j, :, :r] = w[0]
            B[:, j, :r, :] = w[1]
        pack[f"lora_A_{site}"] = torch.from_numpy(A).to(device, dtype)
        pack[f"lora_B_{site}"] = torch.from_numpy(B).to(device, dtype)
    return pack, {a.name: j for j, a in enumerate(adapters)}


def has_pack(layers: dict) -> bool:
    return any(k.startswith("lora_") for k in layers)


def adapter_mask(lora_ids: torch.Tensor, n: int, S: int, dtype) -> torch.Tensor:
    """[n, B * S, 1] in dtype: 1 where row b * S + s takes adapter j. An id
    past the pack clips to the last adapter (JAX's clip), -1 takes none."""
    idx = lora_ids.to(torch.long).clamp_max(n - 1)
    sel = (idx[None] == torch.arange(n, device=lora_ids.device)[:, None]) & (lora_ids >= 0)
    return sel[:, :, None].expand(n, lora_ids.shape[0], S).reshape(n, -1, 1).to(dtype)


def lora_delta(A: torch.Tensor, B_: torch.Tensor, lora_ids: torch.Tensor, x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row's adapter delta for one layer's projection: A [n, in, R] and
    B_ [n, R, out] the layer's slices, lora_ids [B] (-1: base, zero delta),
    x [B, S, in] -> [B, S, out] in x's dtype. mask: adapter_mask's, made
    once a forward (built here when None)."""
    Bsz, S, _ = x.shape
    n, _, R = A.shape
    if mask is None:
        mask = adapter_mask(lora_ids, n, S, x.dtype)
    h = torch.matmul(x.reshape(1, Bsz * S, -1).to(A.dtype), A) * mask  # [n, rows, R]
    out = torch.mm(h.transpose(0, 1).reshape(Bsz * S, n * R), B_.reshape(n * R, -1))
    return out.reshape(Bsz, S, -1).to(x.dtype)


def load_peft_adapter(path: str, cfg: ModelConfig, name: Optional[str] = None) -> Adapter:
    """An HF PEFT LoRA directory (adapter_config.json with r and lora_alpha,
    adapter_model.safetensors with keys such as
    base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight, torch
    layout lora_A [r, in] and lora_B [out, r], transposed here), named after
    the directory unless `name`. A layer the file lacks gets zero blocks.
    JAX's load_peft_adapter, read with the port's safetensors reader."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    rank = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", rank))
    f = SafeFile(os.path.join(path, "adapter_model.safetensors"))
    proj_of = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
               "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}
    dims = _matrix_dims(cfg)
    L = cfg.n_layers
    matrices: Dict[str, tuple] = {}
    for key in f.keys():
        if ".lora_A." not in key:
            continue
        parts = key.split(".")
        try:
            i = int(parts[parts.index("layers") + 1])
        except ValueError:
            continue
        proj = next((p for p in parts if p in proj_of), None)
        if proj is None:
            continue
        m = proj_of[proj]
        if m not in matrices:
            di, do = dims[m]
            matrices[m] = (np.zeros((L, di, rank), np.float32),
                           np.zeros((L, rank, do), np.float32))
        matrices[m][0][i] = f.get(key, "cpu").float().numpy().T
        matrices[m][1][i] = f.get(key.replace(".lora_A.", ".lora_B."), "cpu").float().numpy().T
    return make_adapter(cfg, name or os.path.basename(os.path.normpath(path)), rank=rank,
                        alpha=alpha, matrices=matrices)
