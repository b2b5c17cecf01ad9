"""Sharding rules: param and state leaves -> this rank's share (port of
llm_inference_lab_tpu/parallel/sharding.py).

JAX declares a PartitionSpec a leaf and GSPMD splits each array into
contiguous blocks (padding a dim that does not divide) and inserts the
collectives. The port writes Megatron-style tensor parallelism out by hand,
so where a rule puts ``model`` on a leaf, ``shard_params`` takes this rank's
part in the order the sharded forward (models/transformer.py) reads it,
which for the fused leaves is not GSPMD's contiguous block:

  w_qkv, b_qkv  [L, D, (H+2KV)dh]  the rank's Q heads, then its K heads and
                                   its V heads (head_layout)
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

Each rank computes its share of what the whole model computes and nothing
else, whatever the sizes. Heads: a rank holds a block of the KV heads and
their query heads when the KV heads split; with fewer KV heads than ranks
(n % KV == 0) it holds the one KV head its queries read, replicated over
the ranks that share it, and each KV group is padded with zero query heads
so every rank's GQA group is the same; otherwise zero KV heads pad the
axis. The MLP width, the vocabulary and (under the expert axis) the experts
are padded with zero columns, rows or experts to a multiple of the axis
(ff_per_rank: of 2n for the MLP). Zero query heads have zero rows of wo,
zero MLP columns zero rows of w_down, so their terms add nothing; a padded
vocab row is never looked up and the head's padded columns are cut after
the gather; a padded expert lies past the router's columns and is never
picked. A quantized leaf's padding is what quantize gives for zeros, and an
int4 leaf is padded before it is packed again, so a rank's bytes are those
of its padded slice. ``unshard_params`` drops the padding.

A LoRA pack (models/lora.py) splits where its site's projection does: a
column site's B by the projection's columns, a row site's A by its rows.

Under the stage axis every leaf of params["layers"] keeps layers
[s L/S, (s+1) L/S) (a QuantTensor's bytes and scales sliced on L); under the
expert axis a MoE layer's expert stacks (w_gate_up [L, E, D, 2F], w_down
[L, E, F, D]) keep their block of experts, dim 1, as JAX's _spec_for puts
them on ``expert``; the router stays whole. The axes apply in that order,
then the model axis's shards.

``PARAM_RULES`` and ``_spec_for`` are JAX's, with a spec as a tuple of axis
names. ``shard_state`` gives this rank's rows and heads of a DecodeState as
JAX's ``_cache_sharding`` lays them out: the layers on ``stage``, the batch
on ``data``, KV heads on ``model`` (head_layout's), T on ``seq`` (the
cache's t0 set), another dim that does not divide left whole; a paged pool
keeps its page axis whole on every rank (the coordinator's page ids are
global).
"""

from __future__ import annotations

import dataclasses
import re
from functools import lru_cache
from typing import Any, Dict, List, Optional

import torch

from llm_inference_lab_tpu_torch.core.state import FIELDS, DecodeState
from llm_inference_lab_tpu_torch.models.base import KVCache, Model, ModelConfig, RankConfig
from llm_inference_lab_tpu_torch.models.paged import PagedKVCache
from llm_inference_lab_tpu_torch.ops.quant import (
    EmbedQuant,
    EmbedQuant4,
    QuantTensor,
    int4_rows,
    pack_int4,
    quantize_int4,
    quantize_int8,
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
    "['layers']['w_qkv']"; stage puts a ['layers'] leaf's stacked-layer axis
    on "stage", expert a MoE expert stack's dim 1 on "expert"."""
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def head_layout(n_heads: int, n_kv_heads: int, n: int, r: int) -> tuple:
    """Rank r's query heads and KV heads over a model axis of n (each a list
    of global head indices in the order the rank's fused leaves hold them,
    -1 a zero head), every rank the same GQA group:

      KV heads that split   their block of KV heads and those heads' groups;
      KV heads fewer, n % KV == 0
                            one KV head, replicated over the n / KV ranks
                            that share it, its group padded with zero heads
                            to a multiple of n / KV and split over them;
      otherwise             KV heads padded with zero heads (and their zero
                            groups) to a multiple of n.

    A zero query head's rows of wo are zero and a zero KV head's keys and
    values are zero, so no rank adds anything the whole model does not."""
    g = n_heads // n_kv_heads
    if n_kv_heads % n and n % n_kv_heads == 0:
        m = n // n_kv_heads
        per = _round_up(g, m) // m
        j, first = r // m, (r % m) * per
        return [j * g + i if i < g else -1 for i in range(first, first + per)], [j]
    per_kv = _round_up(n_kv_heads, n) // n
    kv = [j if j < n_kv_heads else -1 for j in range(r * per_kv, (r + 1) * per_kv)]
    return [j * g + i if j >= 0 else -1 for j in kv for i in range(g)], kv


def ff_per_rank(d_ff: int, n: int) -> int:
    """A rank's MLP width over a model axis of n: d_ff / n, or where it does
    not split the width padded with zero columns to a multiple of 2n (so an
    int4 shard's rows pack into bytes)."""
    return d_ff // n if d_ff % n == 0 else _round_up(d_ff, 2 * n) // n


def _block_pad(size: int, per: int, r: int) -> torch.Tensor:
    """Entries [r per, (r + 1) per) of a dim of `size` padded to a multiple
    of per: -1 past the end."""
    idx = torch.arange(r * per, (r + 1) * per)
    return torch.where(idx < size, idx, -1)


def _head_idx(heads, dh: int) -> torch.Tensor:
    """The dh entries of each head (-1 for a zero head's)."""
    idx = torch.tensor(heads)[:, None] * dh + torch.arange(dh)[None]
    return torch.where(torch.tensor(heads)[:, None] >= 0, idx, -1).reshape(-1)


def _shift(idx: torch.Tensor, by: int) -> torch.Tensor:
    return torch.where(idx >= 0, idx + by, -1)


# The LoRA pack's leaves the model axis splits (models/lora.py; JAX has no
# rule for them): a column site's B as its projection's columns, a row
# site's A as its projection's rows. The others stay whole.
_LORA_COLUMNS = {"lora_B_qkv": "w_qkv", "lora_B_gate_up": "w_gate_up"}
_LORA_ROWS = {"lora_A_o": "wo", "lora_A_down": "w_down"}


def _columns(name: str, cfg: ModelConfig, r: int, n: int) -> torch.Tensor:
    """Rank r's columns of a column-parallel leaf, in the sharded forward's
    order (-1 a zero column): the fused QKV's q heads, then its k heads and
    its v heads (head_layout); the fused gate/up's gate columns, then its up
    columns; a vocab block of the head."""
    name = _LORA_COLUMNS.get(name, name)
    if name in ("w_qkv", "b_qkv"):
        dh = cfg.head_dim
        q_heads, kv_heads = head_layout(cfg.n_heads, cfg.n_kv_heads, n, r)
        q, kv = cfg.n_heads * dh, cfg.n_kv_heads * dh
        kv_idx = _head_idx(kv_heads, dh)
        return torch.cat([_head_idx(q_heads, dh), _shift(kv_idx, q), _shift(kv_idx, q + kv)])
    if name == "lm_head":
        return _block_pad(cfg.vocab_size, -(-cfg.vocab_size // n), r)
    cols = _block_pad(cfg.d_ff, ff_per_rank(cfg.d_ff, n), r)
    return torch.cat([cols, _shift(cols, cfg.d_ff)]) if name == "w_gate_up" else cols


def _rows(name: str, cfg: ModelConfig, r: int, n: int) -> torch.Tensor:
    """Rank r's rows of a row-parallel leaf (-1 a zero row): wo's the rows
    of its query heads, in _columns' head order; w_down's and w_proj's those
    of its MLP columns."""
    name = _LORA_ROWS.get(name, name)
    if name == "wo":
        return _head_idx(head_layout(cfg.n_heads, cfg.n_kv_heads, n, r)[0], cfg.head_dim)
    return _block_pad(cfg.d_ff, ff_per_rank(cfg.d_ff, n), r)


def _vocab_rows(cfg: ModelConfig, r: int, n: int) -> torch.Tensor:
    return _block_pad(cfg.vocab_size, -(-cfg.vocab_size // n), r)


def _model_dim(path: str, name: str, ndim: int) -> Optional[int]:
    """The dim a leaf's rule puts on ``model`` (negative), or None; a LoRA
    pack's leaves by _LORA_COLUMNS and _LORA_ROWS."""
    if name.startswith("lora_"):
        return -1 if name in _LORA_COLUMNS else -2 if name in _LORA_ROWS else None
    spec = _spec_for(path, ndim)
    return spec.index("model") - len(spec) if "model" in spec else None


def _index(path: str, name: str, ndim: int, cfg: ModelConfig, r: int,
           n: int) -> Optional[tuple]:
    """(dim, rank r's indices along it) of a leaf the model axis splits, or
    None for a leaf every rank holds whole."""
    dim = _model_dim(path, name, ndim) if ndim else None
    if dim is None:
        return None
    if name == "embed":
        return dim, _vocab_rows(cfg, r, n)
    return dim, (_columns(name, cfg, r, n) if dim == -1 else _rows(name, cfg, r, n))


def _whole(name: str, cfg: ModelConfig) -> int:
    """The whole size of the dim the model axis splits in a leaf."""
    name = _LORA_COLUMNS.get(name, _LORA_ROWS.get(name, name))
    if name in ("w_qkv", "b_qkv"):
        return (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    if name == "wo":
        return cfg.n_heads * cfg.head_dim
    if name in ("embed", "lm_head"):
        return cfg.vocab_size
    return 2 * cfg.d_ff if name == "w_gate_up" else cfg.d_ff


def _take(t: torch.Tensor, dim: int, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """t's entries idx along dim, `fill` where idx is -1: a contiguous copy."""
    idx = idx.to(t.device)
    out = t.index_select(dim % t.ndim, idx.clamp_min(0))
    pad = idx < 0
    if bool(pad.any()):
        shape = [1] * out.ndim
        shape[dim] = -1
        out = out.masked_fill(pad.view(shape), fill)
    return out.contiguous()


def _scatter(parts: List[torch.Tensor], dim: int, idxs: List[torch.Tensor],
             size: int) -> torch.Tensor:
    """The whole dim of `size` from every rank's entries (_take's inverse: a
    zero entry dropped, a replicated one written by each of its ranks)."""
    first = parts[0]
    shape = list(first.shape)
    shape[dim] = size
    out = first.new_zeros(shape)
    for part, idx in zip(parts, idxs):
        idx = idx.to(first.device)
        keep = (idx >= 0).nonzero().flatten()
        out.index_copy_(dim % out.ndim, idx[keep], part.index_select(dim % part.ndim, keep))
    return out


@lru_cache(maxsize=None)
def _zero(bits: int) -> tuple:
    """(byte, scale) that quantize gives a zero column of a weight at `bits`
    (int8: 0 and the clamped scale; int4: the packed pair of zeros, 8), so
    a padded shard holds what quantize gives for its padded slice."""
    qt = quantize_int8(torch.zeros(1, 1)) if bits == 8 else quantize_int4(torch.zeros(2, 1))
    return int(qt.data[0, 0]), float(qt.scale[0])


def _int4_take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int4 rows idx of packed data [.., K/2, N] (every split's: a run of
    rows, then -1s), zero where idx is -1, packed again (pack_int4) at
    len(idx) rows; only the run's packed rows are read."""
    keep = idx[idx >= 0]
    if not len(keep):
        return pack_int4(data.new_zeros((*data.shape[:-2], len(idx), data.shape[-1])))
    lo = int(keep[0])
    vals = int4_rows(data, lo, lo + len(keep))
    return pack_int4(_take(vals, -2, torch.where(idx >= 0, idx - lo, -1)))


def _shard_leaf(path: str, name: str, leaf: Any, cfg: ModelConfig, r: int, n: int) -> Any:
    if isinstance(leaf, (EmbedQuant, EmbedQuant4)):
        rows = _vocab_rows(cfg, r, n)
        if isinstance(leaf, EmbedQuant):
            return EmbedQuant(_take(leaf.q, 0, rows), _take(leaf.scale, 0, rows, _zero(8)[1]))
        byte, scale = _zero(4)
        return EmbedQuant4(QuantTensor(_take(leaf.qt.data, -1, rows, byte),
                                       _take(leaf.qt.scale, 0, rows, scale), bits=4),
                           _take(leaf.rq, 0, rows, byte))
    quant = isinstance(leaf, QuantTensor)
    ndim = leaf.data.ndim if quant else getattr(leaf, "ndim", 0)
    got = _index(path, name, ndim, cfg, r, n)
    if got is None:
        return leaf  # replicated: the same tensor on every rank
    dim, idx = got
    if not quant:
        return _take(leaf, dim, idx)
    if dim == -1:
        byte, scale = _zero(leaf.bits)
        return QuantTensor(_take(leaf.data, -1, idx, byte), _take(leaf.scale, -1, idx, scale),
                           leaf.bits)
    if len(idx) % 2 and leaf.bits == 4:
        raise ValueError(f"an int4 row shard needs an even row count, got {len(idx)}")
    data = _int4_take_rows(leaf.data, idx) if leaf.bits == 4 else _take(leaf.data, -2, idx)
    return QuantTensor(data.contiguous(), leaf.scale.clone(), leaf.bits)


def _map_tree(params: Dict, fn, keys=()) -> Dict:
    out = {}
    for k, v in params.items():
        out[k] = (_map_tree(v, fn, keys + (k,)) if isinstance(v, dict)
                  else fn(_keystr(keys + (k,)), k, v))
    return out


def _moe_leaf(path: str, ndim: int) -> bool:
    """A MoE expert stack ([L, E, ...]): the leaves _spec_for puts on the
    expert axis."""
    return "expert" in _spec_for(path, ndim, expert=True)


def _sizes(mesh, cfg: ModelConfig, axes) -> tuple:
    """(model, stage, seq, expert) sizes of the axes that apply (those named
    in `axes`, all by default; expert only for a MoE model)."""
    def size(axis):
        return mesh.shape.get(axis, 1) if axes is None or axis in axes else 1

    return size("model"), size("stage"), size("seq"), size("expert") if cfg.moe else 1


def shard_config(cfg: ModelConfig, mesh, microbatches: Optional[int] = None,
                 axes=None) -> ModelConfig:
    """The config of this rank's share of the model: under the model axis
    its heads (head_layout: padded or replicated where they do not split),
    its MLP width (ff_per_rank), the full model's head dim and vocabulary
    (the head's padded columns are cut after the gather) and the model
    group (tp); under the stage axis its layers (n_layers, layer0) and the
    stage group (pp, with the forward's microbatches); under the seq axis
    the seq group (sp); under the expert axis, for a MoE model, the expert
    group (ep; experts that do not split are padded with experts the router
    never picks). cfg itself when no axis applies. Raises JAX's error for
    layers that do not split over the stage axis. axes: the axes to apply
    (all by default; the engine's draft takes no stage axis)."""
    n, stage, seq, expert = _sizes(mesh, cfg, axes)
    if n == stage == seq == expert == 1:
        return cfg
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    axes = {}
    if n > 1:
        q_heads, kv_heads = head_layout(cfg.n_heads, cfg.n_kv_heads, n, 0)
        fields.update(n_heads=len(q_heads), n_kv_heads=len(kv_heads),
                      d_ff=ff_per_rank(cfg.d_ff, n), head_dim_override=cfg.head_dim)
        axes["tp"] = mesh.tp
    if stage > 1:
        if cfg.n_layers % stage:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by {stage} stages")
        per = cfg.n_layers // stage
        fields["n_layers"] = per
        axes.update(pp=mesh.axis("stage"), layer0=mesh.coord("stage") * per,
                    pp_microbatches=microbatches)
    if seq > 1:
        axes["sp"] = mesh.axis("seq")
    if expert > 1:
        axes["ep"] = mesh.axis("expert")
    return RankConfig(**fields, **axes)


def _stage_leaf(leaf: Any, s: int, n: int) -> Any:
    """Layers [s L/n, (s+1) L/n) of a stacked leaf (a QuantTensor's bytes and
    scales), a contiguous copy."""
    if isinstance(leaf, QuantTensor):
        return QuantTensor(_stage_leaf(leaf.data, s, n), _stage_leaf(leaf.scale, s, n), leaf.bits)
    L = leaf.shape[0]
    return leaf[s * L // n:(s + 1) * L // n].contiguous()


def _experts(cfg: ModelConfig, e: int, n: int) -> torch.Tensor:
    """Expert rank e's experts of n ranks: a block of E padded to a multiple
    of n (-1 a zero expert, past the router's E columns, so never picked)."""
    return _block_pad(cfg.n_experts, -(-cfg.n_experts // n), e)


def shard_params(params: Dict, mesh, cfg: ModelConfig, axes=None) -> Dict:
    """This rank's tree of the full params (cfg: the full model's config,
    which the fused leaves' head order and the padding need): its layers
    under the stage axis, its experts under the expert axis, its model
    shards (a LoRA pack's leaves too: _LORA_COLUMNS, _LORA_ROWS). Sharded
    leaves are contiguous copies, zero where padded (a quantized leaf's
    padding what quantize gives for zeros); replicated leaves are the full
    tree's own tensors. The full tree is left as it was. axes: as
    shard_config's."""
    n, stage, _, expert = _sizes(mesh, cfg, axes)
    if n == stage == expert == 1:
        return params
    shard_config(cfg, mesh, axes=axes)  # the checks
    r, st, ex = mesh.coord("model"), mesh.coord("stage"), mesh.coord("expert")

    def one(path, name, leaf):
        if stage > 1 and "['layers']" in path:
            leaf = _stage_leaf(leaf, st, stage)
        ndim = leaf.data.ndim if isinstance(leaf, QuantTensor) else getattr(leaf, "ndim", 0)
        if expert > 1 and ndim and _moe_leaf(path, ndim):
            leaf = _take(leaf, 1, _experts(cfg, ex, expert))
        return _shard_leaf(path, name, leaf, cfg, r, n) if n > 1 else leaf

    return _map_tree(params, one)


def shard_model(model: Model, mesh, microbatches: Optional[int] = None, axes=None) -> Model:
    """This rank's share of a whole model: its config (shard_config) and
    params (shard_params); the model itself when no axis applies."""
    cfg = shard_config(model.config, mesh, microbatches, axes)
    if cfg is model.config:
        return model
    return Model(config=cfg, params=shard_params(model.params, mesh, model.config, axes),
                 weights_source=model.weights_source)


def _join_model(parts: List[Dict], cfg: ModelConfig) -> Dict:
    """The tree of a model row from its ranks' trees, in model order: each
    split leaf's entries put back where _shard_leaf took them, the padding
    dropped."""
    n = len(parts)

    def join(path, name, leaves):
        first = leaves[0]
        if isinstance(first, (EmbedQuant, EmbedQuant4)):
            rows = [_vocab_rows(cfg, r, n) for r in range(n)]
            V = cfg.vocab_size
            if isinstance(first, EmbedQuant):
                return EmbedQuant(_scatter([e.q for e in leaves], 0, rows, V),
                                  _scatter([e.scale for e in leaves], 0, rows, V))
            return EmbedQuant4(QuantTensor(_scatter([e.qt.data for e in leaves], -1, rows, V),
                                           _scatter([e.qt.scale for e in leaves], 0, rows, V),
                                           bits=4),
                               _scatter([e.rq for e in leaves], 0, rows, V))
        quant = isinstance(first, QuantTensor)
        ndim = first.data.ndim if quant else getattr(first, "ndim", 0)
        got = [_index(path, name, ndim, cfg, r, n) for r in range(n)]
        if got[0] is None:
            return first
        dim, idxs = got[0][0], [i for _, i in got]
        N = _whole(name, cfg)
        if not quant:
            return _scatter(leaves, dim, idxs, N)
        if dim == -1:
            return QuantTensor(_scatter([p.data for p in leaves], -1, idxs, N),
                               _scatter([p.scale for p in leaves], -1, idxs, N), first.bits)
        if first.bits == 4:
            rows = [int4_rows(p.data, 0, p.shape[-2]) for p in leaves]
            return QuantTensor(pack_int4(_scatter(rows, -2, idxs, N)), first.scale, 4)
        return QuantTensor(_scatter([p.data for p in leaves], -2, idxs, N), first.scale, 8)

    return _zip_tree(parts, join)


def unshard_params(parts: List[Dict], cfg: ModelConfig,
                   shape: Optional[Dict[str, int]] = None) -> Dict:
    """The full tree from every rank's shard_params tree, in rank order over
    a mesh of `shape` (default: a model axis of every part), shard_params'
    inverse: the same bytes, the padding dropped. The axes are joined from
    the minor one out: the model shards, then (seq and data replicate) the
    expert stacks on dim 1, then the stages' layers on dim 0."""
    from llm_inference_lab_tpu_torch.parallel.mesh import AXES

    shape = shape or {"model": len(parts)}

    def experts(trees):
        k = len(trees)

        def join(path, name, leaves):
            ndim = getattr(leaves[0], "ndim", 0)
            if not (ndim and _moe_leaf(path, ndim)):
                return leaves[0]
            return _scatter(leaves, 1, [_experts(cfg, e, k) for e in range(k)], cfg.n_experts)

        return _zip_tree(trees, join)

    def stages(trees):
        def join(path, name, leaves):
            first = leaves[0]
            if "['layers']" not in path:
                return first
            if isinstance(first, QuantTensor):
                return QuantTensor(torch.cat([p.data for p in leaves]),
                                   torch.cat([p.scale for p in leaves]), first.bits)
            return torch.cat(leaves)

        return _zip_tree(trees, join)

    joins = {"model": lambda trees: _join_model(trees, cfg),
             "seq": lambda trees: trees[0], "data": lambda trees: trees[0],
             "expert": experts if cfg.moe else lambda trees: trees[0], "stage": stages}
    items = list(parts)
    for axis in reversed(AXES):
        k = shape.get(axis, 1)
        if k > 1:
            items = [joins[axis](items[i * k:(i + 1) * k]) for i in range(len(items) // k)]
    return items[0]


def _zip_tree(trees: List[Dict], fn, keys=()) -> Dict:
    out = {}
    for k, v in trees[0].items():
        sub = [t[k] for t in trees]
        out[k] = (_zip_tree(sub, fn, keys + (k,)) if isinstance(v, dict)
                  else fn(_keystr(keys + (k,)), k, sub))
    return out


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
    per-row field's rows on the data axis; the contiguous caches
    [L, B, KVH, T, (D)] their layers on stage, rows on data, KV heads on
    model and T on seq (the slice's t0 set); a paged pool [L, N, KVH, P,
    (D)] only its KV heads (the page axis whole on every rank, as JAX's) and
    its table its rows (JAX replicates the table; a rank's step reads its
    own rows only); rng and steps whole; row0 the global number of the
    rank's first row. The KV heads are the rank's of head_layout: where
    they do not split, the one it shares (JAX replicates the axis) or zero
    heads past the last (their int8 scales ones, as a fresh cache's)."""
    data = (mesh.coords["data"], mesh.shape["data"])
    n, r = mesh.shape["model"], mesh.coords["model"]
    stage = (mesh.coord("stage"), mesh.shape.get("stage", 1))
    seq = (mesh.coord("seq"), mesh.shape.get("seq", 1))

    def heads(t, fill=0):
        if t is None or n == 1:
            return t
        kv = torch.tensor(head_layout(t.shape[2], t.shape[2], n, r)[1])
        return _take(t, 2, kv, fill)

    def cache(c):
        if c is None:
            return None
        if isinstance(c, PagedKVCache):
            return PagedKVCache(k=heads(c.k), v=heads(c.v), table=_part(c.table, {0: data}),
                                k_scale=heads(c.k_scale, 1.0), v_scale=heads(c.v_scale, 1.0))
        dims = {0: stage, 1: data, 3: seq}
        T, n_seq = c.k.shape[3], seq[1]
        t0 = seq[0] * (T // n_seq) if n_seq > 1 and T % n_seq == 0 else None
        return KVCache(_part(heads(c.k), dims), _part(heads(c.v), dims),
                       _part(heads(c.k_scale, 1.0), dims), _part(heads(c.v_scale, 1.0), dims),
                       t0)

    fields = {name: (getattr(state, name) if name in ("rng", "steps")
                     else _part(getattr(state, name), {0: data})) for name in FIELDS}
    B = state.tokens.shape[0]
    split = data[1] > 1 and B % data[1] == 0
    return DecodeState(target_cache=cache(state.target_cache),
                       draft_cache=cache(state.draft_cache), **fields,
                       row0=state.row0 + (data[0] * (B // data[1]) if split else 0))
