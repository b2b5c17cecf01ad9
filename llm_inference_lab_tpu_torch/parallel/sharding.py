"""Sharding rules: param and state leaves -> this rank's share (port of
llm_inference_lab_tpu/parallel/sharding.py).

JAX declares a PartitionSpec a leaf and GSPMD splits each array into
contiguous blocks and inserts the collectives. The port writes
Megatron-style tensor parallelism out by hand, so where a rule puts
``model`` on a leaf, ``shard_params`` takes this rank's part in the order
the sharded forward (models/transformer.py) reads it, which for the fused
leaves is not GSPMD's contiguous block:

  w_qkv, b_qkv  [L, D, (H+2KV)dh]  the rank's Q heads [r H/n, (r+1) H/n),
                                   then its K heads and its V heads
  w_gate_up     [L, D, 2F]         its gate columns, then its up columns
  w_fc, b_fc    [L, D, F]          its block of columns
  wo, w_down,   [L, K, D]          its block of rows (the heads' rows of
  w_proj                           wo, in the same head order)
  embed         [V, D]             its block of vocab rows (EmbedQuant's
                                   rows and scales, EmbedQuant4's head
                                   columns, row-layout rows and scales)
  lm_head       [D, V]             its block of vocab columns
  bo, b_proj, pos_embed, norms     whole on every rank (bo and b_proj are
                                   added once, after the sum)

``PARAM_RULES`` and ``_spec_for`` are JAX's, with a spec as a tuple of axis
names. ``shard_state`` gives this rank's rows and heads of a DecodeState as
JAX's ``_cache_sharding`` lays them out: the batch on ``data``, KV heads on
``model``, a dim that does not divide left whole; a paged pool keeps its
page axis whole on every rank (the coordinator's page ids are global).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional

import torch

from llm_inference_lab_tpu_torch.core.state import FIELDS, DecodeState
from llm_inference_lab_tpu_torch.models.base import KVCache, Model, ModelConfig, RankConfig
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache
from llm_inference_lab_tpu_torch.ops.quant import (
    EmbedQuant,
    EmbedQuant4,
    QuantTensor,
    column_shard,
    int4_rows,
    pack_int4,
    row_shard,
    vocab_shard,
)

# Last param-tree key -> spec WITHOUT the stacked-layer axis (JAX's
# sharding.py:34-46), applied to the trailing dims.
PARAM_RULES = {
    "w_qkv": (None, "model"),
    "wo": ("model", None),
    "w_gate_up": (None, "model"),
    "w_fc": (None, "model"),
    "w_down": ("model", None),
    "w_proj": ("model", None),
    "b_qkv": ("model",),
    "b_fc": ("model",),
    "bo": (),
    "b_proj": (),
    "pos_embed": (),
    "embed": ("model", None),
    "lm_head": (None, "model"),
}

_LAST_KEY = re.compile(r"\['?([^'\[\]]+)'?\]$")


def _spec_for(path: str, ndim: int, stage: bool = False, expert: bool = False) -> tuple:
    """JAX's _spec_for (sharding.py:53): `path` a keystr string such as
    "['layers']['w_qkv']"; stage and expert pad the stacked-layer and
    expert-stack axes as JAX's do (the port refuses both axes, the rule is
    kept whole)."""
    m = _LAST_KEY.search(path)
    spec = PARAM_RULES.get(m.group(1)) if m else None
    is_layer_leaf = "['layers']" in path
    if spec is None:
        if stage and is_layer_leaf and ndim >= 1:
            return ("stage",) + (None,) * (ndim - 1)
        return ()
    pad = ndim - len(spec)
    if pad < 0:  # scale vectors etc.: the trailing dims of the spec
        return tuple(spec[-ndim:])
    lead = ["stage"] if stage and is_layer_leaf and pad >= 1 else [None]
    if expert and is_layer_leaf and pad >= 2:
        lead = lead[:1] + ["expert"]
    lead = lead[:pad]
    return (*lead, *([None] * (pad - len(lead))), *spec)


def _keystr(keys) -> str:
    return "".join(f"['{k}']" for k in keys)


def _block(n_total: int, r: int, n: int) -> torch.Tensor:
    per = n_total // n
    return torch.arange(r * per, (r + 1) * per)


def _columns(name: str, N: int, cfg: ModelConfig, r: int, n: int) -> torch.Tensor:
    """Rank r's columns of a column-parallel leaf of N columns, in the
    sharded forward's order."""
    if name in ("w_qkv", "b_qkv"):
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        if N != q + 2 * kv:
            raise ValueError(f"{name} has {N} columns, not (H + 2 KV) head_dim = {q + 2 * kv}")
        return torch.cat([_block(q, r, n), q + _block(kv, r, n), q + kv + _block(kv, r, n)])
    if name == "w_gate_up":
        f = N // 2
        return torch.cat([_block(f, r, n), f + _block(f, r, n)])
    return _block(N, r, n)


def _model_dim(path: str, ndim: int) -> Optional[int]:
    """The dim a leaf's rule puts on ``model`` (negative), or None."""
    spec = _spec_for(path, ndim)
    return spec.index("model") - len(spec) if "model" in spec else None


def _shard_leaf(path: str, name: str, leaf: Any, cfg: ModelConfig, r: int, n: int) -> Any:
    if name.startswith("lora_"):
        raise NotImplementedError("LoRA under tensor parallelism (model > 1) is not sharded: "
                                  "each site's delta would need the rank's columns")
    if isinstance(leaf, (EmbedQuant, EmbedQuant4)):
        V = leaf.shape[0] if isinstance(leaf, EmbedQuant4) else leaf.q.shape[0]
        return vocab_shard(leaf, r * V // n, (r + 1) * V // n)
    ndim = leaf.data.ndim if isinstance(leaf, QuantTensor) else getattr(leaf, "ndim", 0)
    dim = _model_dim(path, ndim) if ndim else None
    if dim is None:
        return leaf  # replicated: the same tensor on every rank
    if dim == -1:
        N = leaf.shape[-1]
        return column_shard(leaf, _columns(name, N, cfg, r, n).to(
            (leaf.data if isinstance(leaf, QuantTensor) else leaf).device))
    K = leaf.shape[-2]
    r0, r1 = r * K // n, (r + 1) * K // n
    if isinstance(leaf, QuantTensor):
        return row_shard(leaf, r0, r1)
    return leaf[..., r0:r1, :].contiguous()


def _map_tree(params: Dict, fn, keys=()) -> Dict:
    out = {}
    for k, v in params.items():
        out[k] = (_map_tree(v, fn, keys + (k,)) if isinstance(v, dict)
                  else fn(_keystr(keys + (k,)), k, v))
    return out


def shard_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config of this rank's share of the model: its heads and MLP
    width, the full model's head dim, and the mesh's TensorParallel; cfg
    itself at model 1. Raises for what does not split on whole heads or
    vocab rows, and NotImplementedError for a MoE model."""
    n = mesh.shape["model"]
    if n == 1:
        return cfg
    if cfg.moe:
        raise NotImplementedError("a MoE model under a mesh is not sharded (the expert axis "
                                  "is not ported)")
    for what, size in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                       ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if size % n:
            raise ValueError(f"{what} = {size} does not split over the model axis of {n}")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    fields.update(n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n,
                  d_ff=cfg.d_ff // n, head_dim_override=cfg.head_dim)
    return RankConfig(tp=mesh.tp, **fields)


def shard_params(params: Dict, mesh, cfg: ModelConfig) -> Dict:
    """This rank's tree of the full params (cfg: the full model's config,
    which the fused leaves' head order needs). Sharded leaves are
    contiguous copies; replicated leaves are the full tree's own tensors.
    The full tree is left as it was."""
    n = mesh.shape["model"]
    if n == 1:
        return params
    shard_config(cfg, mesh)  # the checks
    r = mesh.coords["model"]
    return _map_tree(params, lambda path, name, leaf: _shard_leaf(path, name, leaf, cfg, r, n))


def shard_model(model: Model, mesh) -> Model:
    """This rank's share of a whole model: its config (shard_config) and
    params (shard_params); the model itself at model 1."""
    if mesh.shape["model"] == 1:
        return model
    return Model(config=shard_config(model.config, mesh),
                 params=shard_params(model.params, mesh, model.config),
                 weights_source=model.weights_source)


def unshard_params(parts: List[Dict], cfg: ModelConfig) -> Dict:
    """The full tree from every rank's shard_params tree, in rank order
    (shard_params' inverse: the same bytes)."""
    n = len(parts)

    def join(path, name, leaves):
        first = leaves[0]
        if isinstance(first, EmbedQuant):
            return EmbedQuant(torch.cat([e.q for e in leaves]), torch.cat([e.scale for e in leaves]))
        if isinstance(first, EmbedQuant4):
            return EmbedQuant4(QuantTensor(torch.cat([e.qt.data for e in leaves], dim=-1),
                                           torch.cat([e.qt.scale for e in leaves]), bits=4),
                               torch.cat([e.rq for e in leaves]))
        quant = isinstance(first, QuantTensor)
        ndim = first.data.ndim if quant else getattr(first, "ndim", 0)
        dim = _model_dim(path, ndim) if ndim else None
        if dim is None:
            return first
        if dim == -1:
            N = first.shape[-1] * n
            idx = torch.cat([_columns(name, N, cfg, r, n) for r in range(n)])
            inv = torch.argsort(idx)

            def gather(ts):
                return torch.cat(ts, dim=-1).index_select(-1, inv.to(ts[0].device))

            if quant:
                return QuantTensor(gather([p.data for p in leaves]),
                                   gather([p.scale for p in leaves]), first.bits)
            return gather(leaves)
        if quant and first.bits == 4:
            rows = [int4_rows(p.data, 0, p.shape[-2]) for p in leaves]
            return QuantTensor(pack_int4(torch.cat(rows, dim=-2)), first.scale, 4)
        if quant:
            return QuantTensor(torch.cat([p.data for p in leaves], dim=-2), first.scale, 8)
        return torch.cat(leaves, dim=-2)

    def walk(trees, keys=()):
        out = {}
        for k, v in trees[0].items():
            sub = [t[k] for t in trees]
            out[k] = (walk(sub, keys + (k,)) if isinstance(v, dict)
                      else join(_keystr(keys + (k,)), k, sub))
        return out

    return walk(parts)


def _part(t: Optional[torch.Tensor], dims: Dict[int, tuple]) -> Optional[torch.Tensor]:
    """t's block along each dim -> (index, count) that divides it (a dim that
    does not divide stays whole, as JAX's _cache_sharding leaves it)."""
    if t is None:
        return None
    for dim, (i, count) in dims.items():
        size = t.shape[dim]
        if count > 1 and size % count == 0:
            per = size // count
            t = t.narrow(dim, i * per, per)
    return t.contiguous()


def shard_state(state: DecodeState, mesh) -> DecodeState:
    """This rank's share of a whole DecodeState (JAX shard_state): every
    per-row field's rows on the data axis; the contiguous caches' rows
    [L, B, KVH, T, (D)] on data and their KV heads on model; a paged pool
    [L, N, KVH, P, (D)] only its KV heads (the page axis whole on every
    rank, as JAX's) and its table its rows (JAX replicates the table; a
    rank's step reads its own rows only); rng and steps whole; row0 the
    global number of the rank's first row."""
    data = (mesh.coords["data"], mesh.shape["data"])
    model = (mesh.coords["model"], mesh.shape["model"])

    def cache(c):
        if c is None:
            return None
        if isinstance(c, PagedKVCache):
            heads = {2: model}
            return PagedKVCache(k=_part(c.k, heads), v=_part(c.v, heads),
                                table=_part(c.table, {0: data}), k_scale=_part(c.k_scale, heads),
                                v_scale=_part(c.v_scale, heads))
        dims = {1: data, 2: model}
        return KVCache(_part(c.k, dims), _part(c.v, dims), _part(c.k_scale, dims),
                       _part(c.v_scale, dims))

    fields = {name: (getattr(state, name) if name in ("rng", "steps")
                     else _part(getattr(state, name), {0: data})) for name in FIELDS}
    B = state.tokens.shape[0]
    split = data[1] > 1 and B % data[1] == 0
    return DecodeState(target_cache=cache(state.target_cache),
                       draft_cache=cache(state.draft_cache), **fields,
                       row0=state.row0 + (data[0] * (B // data[1]) if split else 0))
