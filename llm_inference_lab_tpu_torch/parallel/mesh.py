"""The device mesh over torch.distributed (port of
llm_inference_lab_tpu/parallel/mesh.py).

Axes, as in JAX, in its device order (model minor):
  data   - batch (DP): sequences are independent; continuous-batching slots
           split across this axis.
  stage  - pipeline (PP): stage s holds layers [s L/S, (s+1) L/S) of the
           target and of its cache; microbatches cross the stages by
           send/recv (parallel/pipeline.py forward_pp).
  expert - expert parallelism (EP): a MoE layer's expert stacks split over
           it; each rank's experts' rows are summed over the axis in f32
           (ops/moe.py moe_expert).
  seq    - context parallelism (CP): the single-shot prefill's prompt rows
           split over it and attend by ring attention (parallel/context.py);
           every contiguous cache whose T splits holds its slice of T.
  model  - tensor parallel (TP): attention heads, MLP columns and the vocab
           split across it; its collectives are an all-reduce after each
           row-parallel projection and the embedding, and an all-gather of
           the head's logits (models/transformer.py).

JAX's mesh is a grid of devices that one program sees as global arrays
(GSPMD inserts the collectives). The port runs one process a rank: a
``Mesh`` is this rank's place in the grid (its coordinates) and the process
groups its collectives run over. Ranks are ordered as JAX orders its
devices: rank = the row-major index of (data, stage, expert, seq, model), so
a model group is a run of consecutive ranks and stays within one host.

Each axis above 1 gets a data-plane group on the world's backend (the ranks
that differ only along that axis), as initialize_multihost chose it (NCCL
across cards, gloo where the caller named it, as for several ranks sharing
one card), wrapped in an ``AxisGroup`` that counts its calls and host
seconds in COLLECTIVES; the host's control traffic (the batcher's
broadcasts and gathers of CPU tensors, ``control``) is always a gloo group.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# The axes in JAX's device order (model minor).
AXES = ("data", "stage", "expert", "seq", "model")

# Collective calls of the parallel forward and the host seconds in them
# (every AxisGroup collective): chip_smoke.py reads
# them for each step's share spent in collectives. On a gloo group a CUDA
# tensor's hop by the host first waits for the work queued before it (not
# counted), then the seconds run from the copy to the host to the copy back
# (the peers' wait included); on NCCL they are the enqueue only.
COLLECTIVES = {"calls": 0, "seconds": 0.0}
# The same for the host's control traffic of core/multihost_batching.py
# (its broadcasts and all-gathers of CPU tensors at each poll).
CONTROL = {"calls": 0, "seconds": 0.0}


def _settle(backend: str, t: torch.Tensor) -> bool:
    """Whether a collective of t goes by the host (gloo, a CUDA tensor);
    if so, after the work queued on t's stream has run, so the time of the
    hop is the collective's own."""
    via_host = backend == "gloo" and t.is_cuda
    if via_host:
        torch.cuda.current_stream(t.device).synchronize()
    return via_host


def _tally(t0: float) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0


@dataclass(frozen=True, eq=False)
class AxisGroup:
    """This rank's group along one mesh axis: the group, this rank's index
    on the axis, the axis's size and backend, and the group's global ranks
    in axis order. A config made for the rank (parallel/sharding.py
    shard_config) carries the model axis's as ``tp``, the seq axis's as
    ``sp``, the stage axis's as ``pp`` and the expert axis's as ``ep``, and
    the forward reads them. Through a gloo group a CUDA tensor goes by the
    host: gloo's collectives here take CPU tensors."""

    group: Optional[object]
    rank: int
    size: int
    backend: str
    ranks: Tuple[int, ...] = ()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the group (a new tensor on t's device)."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        buf = t.cpu() if via_host else t.clone()
        dist.all_reduce(buf, group=self.group)
        out = buf.to(t.device) if via_host else buf
        _tally(t0)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' t concatenated on `dim`, in axis order."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        src = (t.cpu() if via_host else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        out = out.to(t.device) if via_host else out
        _tally(t0)
        return out

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' t concatenated on the last dim, in axis order."""
        return self.all_gather(t, -1)

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' t stacked on a new leading dim, in axis order."""
        return self.all_gather(t[None], 0)

    def ring_pass(self, t: torch.Tensor) -> torch.Tensor:
        """JAX's ppermute i -> i + 1 (mod size): t goes to the next rank on the
        axis and the previous rank's comes back (a new tensor on t's
        device). Even ranks send first and odd ranks receive first, so no
        rank waits on a peer that waits on it."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        src = (t.cpu() if via_host else t).contiguous()
        got = torch.empty_like(src)
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        if self.rank % 2 == 0:
            dist.send(src, nxt, group=self.group)
            dist.recv(got, prv, group=self.group)
        else:
            dist.recv(got, prv, group=self.group)
            dist.send(src, nxt, group=self.group)
        out = got.to(t.device) if via_host else got
        _tally(t0)
        return out

    def send_next(self, t: torch.Tensor) -> None:
        """t to the next rank on the axis (a pipeline stage's activation)."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        dist.send((t.cpu() if via_host else t).contiguous(), self.ranks[self.rank + 1],
                  group=self.group)
        _tally(t0)

    def recv_prev(self, like: torch.Tensor) -> torch.Tensor:
        """A tensor of like's shape and dtype from the previous rank on the
        axis, on like's device."""
        via_host = self.backend == "gloo" and like.is_cuda
        t0 = time.perf_counter()
        got = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if via_host else like.device)
        dist.recv(got, self.ranks[self.rank - 1], group=self.group)
        out = got.to(like.device) if via_host else got
        _tally(t0)
        return out

    def broadcast_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last rank's t on every rank of the axis (t gives the shape and
        dtype on the others; a new tensor on t's device)."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        buf = (t.cpu() if via_host else t).contiguous().clone()
        dist.broadcast(buf, self.ranks[-1], group=self.group)
        out = buf.to(t.device) if via_host else buf
        _tally(t0)
        return out


@dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh as this rank sees it. ``shape`` has JAX's keys: data and model
    always, stage, expert and seq when above 1, in JAX's order;
    ``coords`` this rank's index on each axis of ``shape`` (None on a rank
    the mesh leaves out; an axis of size 1 missing from it is at 0);
    ``model_group`` the data-plane group of its model row (None at model
    1); ``control`` a gloo group over the mesh's ranks (None in a single
    process); ``groups`` each axis above 1's AxisGroup of this rank."""

    shape: Dict[str, int]
    rank: int
    coords: Optional[Dict[str, int]]
    backend: str
    model_group: Optional[object] = None
    control: Optional[object] = None
    groups: Dict[str, AxisGroup] = field(default_factory=dict)

    @property
    def size(self) -> int:
        n = 1
        for axis in AXES:
            n *= self.shape.get(axis, 1)
        return n

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axis(self, name: str) -> Optional[AxisGroup]:
        """The AxisGroup of an axis above 1, else None. A mesh made without
        a process group (one process) has the model axis's from its shape."""
        if self.shape.get(name, 1) == 1:
            return None
        got = self.groups.get(name)
        if got is None:
            got = AxisGroup(self.model_group if name == "model" else None, self.coord(name),
                            self.shape[name], self.backend)
        return got

    @property
    def tp(self) -> Optional[AxisGroup]:
        """The model axis as the forward takes it; None at model 1."""
        return self.axis("model")

    def data_slice(self, n: int) -> slice:
        """This rank's rows of n along the data axis (n must divide)."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"{n} rows do not split over the data axis of {d}")
        per = n // d
        i = self.coords["data"]
        return slice(i * per, (i + 1) * per)

    def gather_data(self, local: List) -> List:
        """Every data rank's list, concatenated in data order, on every rank
        (an all_gather_object over the control group; the first rank of each
        data row stands for its row)."""
        if self.shape["data"] == 1:
            return list(local)
        got: List = [None] * self.size
        dist.all_gather_object(got, local, group=self.control)
        per = self.size // self.shape["data"]
        return [x for d in range(self.shape["data"]) for x in got[d * per]]


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, stage: int = 1,
              expert: int = 1) -> Mesh:
    """The mesh of the initialised world (initialize_multihost): data x stage
    x expert x seq x model ranks, model minor, as JAX orders its devices.
    Every rank of the world must call it (it makes the groups, a
    collective: every rank makes every group, in the same order); each axis
    above 1 gets a group on the world's backend (dist.get_backend()). Raises
    JAX's ValueErrors: a world too small, and stage with seq."""
    sizes = dict(data=data, stage=stage, expert=expert, seq=seq, model=model)
    world, rank = _world()
    need = data * stage * expert * seq * model
    if need > world:
        raise ValueError(f"mesh {data}x{stage}x{expert}x{seq}x{model} needs {need} "
                         f"devices, have {world}")
    if stage > 1 and seq > 1:
        raise ValueError("stage (pipeline) and seq (ring-attention) axes "
                         "are mutually exclusive")
    shape = {a: n for a, n in sizes.items() if n > 1 or a in ("data", "model")}
    if world == 1:
        return Mesh(shape, 0, {a: 0 for a in shape}, "gloo")
    backend = dist.get_backend()
    inside = rank < need
    dims = [sizes[a] for a in AXES]
    coords = ({a: i for a, i in zip(AXES, _unravel(rank, dims)) if a in shape} if inside
              else None)
    groups: Dict[str, AxisGroup] = {}
    for i, axis in enumerate(AXES):
        if sizes[axis] == 1 or axis == "data":  # the data axis has no data-plane collective
            continue
        others = [range(n) if j != i else range(1) for j, n in enumerate(dims)]
        for base in itertools.product(*others):  # every rank makes every group, in one order
            ranks = []
            for k in range(sizes[axis]):
                idx = list(base)
                idx[i] = k
                ranks.append(_ravel(idx, dims))
            g = dist.new_group(ranks, backend=backend)
            if inside and rank in ranks:
                groups[axis] = AxisGroup(g, ranks.index(rank), sizes[axis], backend,
                                         tuple(ranks))
    control = dist.new_group(list(range(need)), backend="gloo")
    model_group = groups["model"].group if "model" in groups else None
    return Mesh(shape, rank, coords, backend, model_group, control if inside else None, groups)


def _ravel(idx, dims) -> int:
    """The row-major rank of coordinates idx in a grid of dims."""
    r = 0
    for i, n in zip(idx, dims):
        r = r * n + i
    return r


def _unravel(rank: int, dims) -> List[int]:
    """The coordinates of a row-major rank in a grid of dims."""
    out = []
    for n in reversed(dims):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Default: every rank on the model (TP) axis, the right default for
    low-latency inference of one large model (JAX's auto_mesh)."""
    return make_mesh(data=1, model=n_devices or _world()[0])
