"""The device mesh over torch.distributed (port of
llm_inference_lab_tpu/parallel/mesh.py).

Axes, as in JAX:
  data  - batch (DP): sequences are independent; continuous-batching slots
          split across this axis.
  model - tensor parallel (TP): attention heads, MLP columns and the vocab
          split across it; its collectives are an all-reduce after each
          row-parallel projection and the embedding, and an all-gather of
          the head's logits (models/transformer.py).

JAX's mesh is a grid of devices that one program sees as global arrays
(GSPMD inserts the collectives). The port runs one process a rank: a
``Mesh`` is this rank's place in the grid (its coordinates) and the process
groups its collectives run over. Ranks are ordered with ``model`` minor, as
JAX orders its devices (rank = data_index * model + model_index), so a model
group is a run of consecutive ranks and stays within one host.

Each group's backend is explicit: the data plane (``model_group``) uses the
world's, as initialize_multihost chose it (NCCL across cards, gloo where
the caller named it, as for several ranks sharing one card); the host's
control traffic (the batcher's broadcasts and gathers of CPU
tensors, ``control``) is always a gloo group. The ``seq``, ``stage`` and
``expert`` axes are not ported: each raises NotImplementedError.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

# Collective calls of the tensor-parallel forward and the host seconds in
# them (TensorParallel.all_reduce / all_gather_last): chip_smoke.py reads
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


@dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's share of a tensor-parallel model: its model group, its
    index in it and the group's size and backend. A config made for the
    rank (parallel/sharding.py shard_config) carries it, and the forward
    reads it."""

    group: Optional[object]
    rank: int
    size: int
    backend: str

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the model group (a new tensor on t's device).
        Through a gloo group a CUDA tensor goes by the host: gloo's
        collectives here take CPU tensors."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        buf = t.cpu() if via_host else t.clone()
        dist.all_reduce(buf, group=self.group)
        out = buf.to(t.device) if via_host else buf
        COLLECTIVES["calls"] += 1
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        return out

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' t concatenated on the last dim, in rank order."""
        via_host = _settle(self.backend, t)
        t0 = time.perf_counter()
        src = (t.cpu() if via_host else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=-1)
        out = out.to(t.device) if via_host else out
        COLLECTIVES["calls"] += 1
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        return out


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh as this rank sees it. ``shape`` has JAX's keys
    ({"data": d, "model": m}), ``coords`` this rank's index on each axis
    (None on a rank the mesh leaves out), ``model_group`` the data-plane
    group of its model row (None at model 1), ``control`` a gloo group over
    the mesh's ranks (None in a single process)."""

    shape: Dict[str, int]
    rank: int
    coords: Optional[Dict[str, int]]
    backend: str
    model_group: Optional[object] = None
    control: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def tp(self) -> Optional[TensorParallel]:
        """The model axis as the forward takes it; None at model 1."""
        if self.shape["model"] == 1:
            return None
        return TensorParallel(self.model_group, self.coords["model"], self.shape["model"],
                              self.backend)

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
        (an all_gather_object over the control group; one model rank of
        each row stands for its row)."""
        if self.shape["data"] == 1:
            return list(local)
        got: List = [None] * self.size
        dist.all_gather_object(got, local, group=self.control)
        m = self.shape["model"]
        return [x for d in range(self.shape["data"]) for x in got[d * m]]


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, stage: int = 1,
              expert: int = 1) -> Mesh:
    """The mesh of the initialised world (initialize_multihost): data x
    model ranks, model minor. Every rank of the world must call it (it
    makes the groups, a collective); the model groups take the world's
    backend (dist.get_backend()). Raises NotImplementedError for a seq,
    stage or expert axis above 1 (whatever the world's size), and JAX's
    ValueError when the world is too small."""
    for name, n in (("seq", seq), ("stage", stage), ("expert", expert)):
        if n > 1:
            raise NotImplementedError(f"the {name!r} mesh axis is not ported (only data and "
                                      "model are)")
    world, rank = _world()
    need = data * stage * expert * seq * model
    if need > world:
        raise ValueError(f"mesh {data}x{stage}x{expert}x{seq}x{model} needs {need} "
                         f"devices, have {world}")
    shape = {"data": data, "model": model}
    if world == 1:
        return Mesh(shape, 0, {"data": 0, "model": 0}, "gloo")
    backend = dist.get_backend()
    inside = rank < need
    coords = {"data": rank // model, "model": rank % model} if inside else None
    model_group = None
    for d in range(data):  # every rank makes every group (dist.new_group is collective)
        ranks = list(range(d * model, (d + 1) * model))
        g = dist.new_group(ranks, backend=backend) if model > 1 else None
        if inside and coords["data"] == d:
            model_group = g
    control = dist.new_group(list(range(need)), backend="gloo")
    return Mesh(shape, rank, coords, backend, model_group, control if inside else None)


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Default: every rank on the model (TP) axis, the right default for
    low-latency inference of one large model (JAX's auto_mesh)."""
    return make_mesh(data=1, model=n_devices or _world()[0])
