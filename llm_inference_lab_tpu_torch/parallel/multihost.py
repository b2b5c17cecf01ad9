"""Several processes of the port as one mesh (port of
llm_inference_lab_tpu/parallel/multihost.py), and a launcher that starts
them.

Each rank is one process. On every rank, before any collective:

    initialize_multihost()                  # torchrun's RANK, WORLD_SIZE, MASTER_*
    mesh = make_multihost_mesh(model_per_host=2)
    eng = Engine(cfg, mesh=mesh)
    batcher = MultiHostBatcher(eng, n_slots=8)   # core/multihost_batching.py

``initialize_multihost`` takes its values from its arguments or from
torchrun's variables, and is a no-op in a single process. Its backend is
NCCL unless the caller names another: several ranks that share one card
(NCCL refuses two ranks on one device) name gloo, and nothing switches it
quietly. ``broadcast_from_rank0`` is JAX's broadcast_one_to_all for host
arrays, over a gloo group of CPU tensors whatever the data plane's backend.

``launch(fn, world_size, ...)`` starts world_size gloo ranks with
torch.multiprocessing's spawn context, joined through a file:// store in a
temporary directory (no TCP port, so concurrent launches never collide),
runs fn(*args) on each and returns their results in rank order. fn must be
importable by the child (a function of the port, or of a helper module
that imports no JAX: a child unpickling a function from a test module
would import that module's JAX). Each rank's output goes to a log file of
its own; a rank that raises, dies or outlives the time limit makes launch
kill every rank and raise with that rank's log.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from llm_inference_lab_tpu_torch.parallel.mesh import Mesh, make_mesh

_CONTROL: List[Optional[object]] = [None]  # the world's gloo group (initialize_multihost)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: str = "nccl",
                         init_method: Optional[str] = None) -> dict:
    """torch.distributed.init_process_group from the arguments, else from
    torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT. A no-op with
    one process, or when the group is already up. coordinator_address:
    "host:port" (tcp://); init_method: any init method instead (the
    launcher's file:// store). Returns the topology (JAX's keys)."""
    if not dist.is_initialized():
        n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
        if n > 1:
            rank = process_id if process_id is not None else int(os.environ["RANK"])
            if init_method is None:
                addr = coordinator_address or (f"{os.environ['MASTER_ADDR']}:"
                                               f"{os.environ['MASTER_PORT']}")
                init_method = f"tcp://{addr}"
            dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
            _CONTROL[0] = (None if dist.get_backend() == "gloo"
                           else dist.new_group(list(range(n)), backend="gloo"))
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1 if world == 1 else world))
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": world, "local_devices": local, "global_devices": world}


def make_multihost_mesh(model_per_host: Optional[int] = None) -> Mesh:
    """(data, model) mesh where ``model`` never crosses a host boundary:
    model = model_per_host (default torchrun's LOCAL_WORLD_SIZE, else the
    whole world), data = world / model. Consecutive ranks share a host, so
    each model group is one host's ranks."""
    info = initialize_multihost()
    model = model_per_host or info["local_devices"]
    world = info["process_count"]
    if world % model:
        raise ValueError(f"model_per_host={model} must divide the {world} ranks")
    return make_mesh(data=world // model, model=model)


def broadcast_from_rank0(x):
    """Rank 0's host arrays on every rank (JAX broadcast_one_to_all): a numpy
    array or a tuple/list of them, returned in the same structure; in a
    single process, x itself."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    many = isinstance(x, (tuple, list))
    out = []
    for a in (x if many else (x,)):
        t = torch.from_numpy(np.ascontiguousarray(a)).clone()
        dist.broadcast(t, src=0, group=_CONTROL[0])
        out.append(t.numpy())
    return type(x)(out) if many else out[0]


def _rank_main(fn: Callable, rank: int, world: int, init_method: str, args: tuple, results,
               log_path: str, threads: Optional[int]) -> None:
    log = open(log_path, "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        initialize_multihost(num_processes=world, process_id=rank, backend="gloo",
                             init_method=init_method)
        results.put((rank, True, fn(*args)))
    except Exception:  # noqa: BLE001 - handed to the parent, which raises
        traceback.print_exc()
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        log.flush()


def _tail(path: str, n: int = 12000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return "(no log)"


def launch(fn: Callable, world_size: int, args: Sequence[Any] = (), timeout: float = 600.0,
           threads: Optional[int] = None) -> list:
    """fn(*args) on world_size ranks of one gloo process group (the CPU
    tests, and ranks that share a card); their results in rank order.
    threads: each rank's torch intra-op threads. Raises RuntimeError with
    the rank's log when a rank raises, dies or is not done within timeout
    seconds; every rank is stopped before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="port-ranks-")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    results = ctx.Queue()
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, tuple(args), results, logs[r],
                               threads))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got: dict = {}
        while len(got) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                if dead:  # a rank that died without a word (a crash, a kill)
                    r = dead[0]
                    raise RuntimeError(f"rank {r} of {world_size} exited with code "
                                       f"{procs[r].exitcode} and no result:\n{_tail(logs[r])}")
                if time.monotonic() > deadline:
                    r = min(set(range(world_size)) - set(got))
                    raise RuntimeError(f"rank {r} of {world_size} not done within {timeout} s:"
                                       f"\n{_tail(logs[r])}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}\n"
                                   f"--- its log ---\n{_tail(logs[rank])}")
            got[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
