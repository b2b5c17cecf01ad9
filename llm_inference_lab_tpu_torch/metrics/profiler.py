"""Structured profiling: per-step timings, the acceptance histogram, traces.

Port of llm_inference_lab_tpu/metrics/profiler.py:

- ``MemoryStats`` / ``device_memory_stats``: the card's allocated and peak
  bytes (torch.cuda's allocator counters), and the host's peak RSS always;
  ``as_dict`` keeps JAX's three keys.
- ``slope_chain_ms``: the cost of one link of a dependent chain, as the
  slope between chains of two lengths, so the fixed cost of starting and
  finishing a chain cancels. On the card a chain is the replay of a CUDA
  graph captured over one link, timed by CUDA events: the phases of
  ``Engine.profile_phases`` are then timed as the decode loop runs the step
  (graph replays), and eager launch time stays out of them; under a mesh
  axis whose collectives go by the host (the engine's eager_loops) the
  links run eagerly between the same events, as that engine's decode loop
  runs the step. On the CPU the chain runs eagerly under ``perf_counter``.
- ``StructuredProfiler`` with JAX's fields and methods. ``time_step`` times
  a step on the card with CUDA events, read when ``summary`` (or
  ``flush``) needs them, not by a host sync after every step; ``trace``
  records a ``torch.profiler`` Chrome trace where JAX's records a
  ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import resource
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclass
class MemoryStats:
    device_bytes_in_use: Optional[int] = None
    device_peak_bytes: Optional[int] = None
    host_rss_mb: Optional[float] = None

    def as_dict(self) -> dict:
        return {
            "device_mem_mb": (self.device_bytes_in_use / 1e6
                              if self.device_bytes_in_use is not None else None),
            "device_peak_mb": (self.device_peak_bytes / 1e6
                               if self.device_peak_bytes is not None else None),
            "mem_rss_mb": self.host_rss_mb,
        }


def device_memory_stats(device=None) -> MemoryStats:
    """The card's allocated and peak allocated bytes when `device` is a CUDA
    device (None: the current one, if CUDA is up), and the process's peak
    RSS in MB."""
    out = MemoryStats(host_rss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0)
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        out.device_bytes_in_use = torch.cuda.memory_allocated(dev)
        out.device_peak_bytes = torch.cuda.max_memory_allocated(dev)
    return out


def slope_chain_ms(fn: Callable, params: Any, init: Any, lo: int = 10, hi: int = 40,
                   eager: bool = False) -> float:
    """The cost in ms of one link ``fn(params, carry)`` of a dependent chain:
    (t(hi) - t(lo)) / (hi - lo), each t the median of 3 chains, each chain
    from `init` (its tensors are put back before every chain, outside the
    timing, as JAX's chains all start from init). fn updates the carry in
    place (the next link reads what this one wrote). Where the carry's
    tensors lie on the card, a chain is that many replays of one CUDA graph
    captured over a link, timed between two CUDA events, or with eager
    (a link holding a collective that goes by the host, which no graph
    holds) that many eager links between the same events; on the CPU the
    links run eagerly."""
    leaves = _tensors(init)
    saved = [t.clone() for t in leaves]
    if leaves and leaves[0].is_cuda:
        timed = (_eager_chain(fn, params, init, leaves[0].device) if eager
                 else _graph_chain(fn, params, init, leaves[0].device))
    else:
        def timed(n: int) -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(params, init)
            return (time.perf_counter() - t0) * 1e3

    def run(n: int) -> float:
        for t, v in zip(leaves, saved):
            t.copy_(v)
        return timed(n)

    run(lo)  # warm-up
    t_lo = sorted(run(lo) for _ in range(3))[1]
    t_hi = sorted(run(hi) for _ in range(3))[1]
    return (t_hi - t_lo) / (hi - lo)


def _eager_chain(fn: Callable, params: Any, carry: Any, dev: torch.device):
    """A function n -> ms of n eager links on the card, between two CUDA
    events (the host's launches and collectives inside the span)."""
    def run(n: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(params, carry)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return run


def _tensors(x: Any) -> List[torch.Tensor]:
    """The tensors of a carry: a tensor, a tuple or list, or an object's
    attributes (a DecodeState, a KV cache), depth first."""
    if isinstance(x, torch.Tensor):
        return [x]
    items = (x if isinstance(x, (tuple, list))
             else vars(x).values() if hasattr(x, "__dict__") else ())
    return [t for item in items for t in _tensors(item)]


def _graph_chain(fn: Callable, params: Any, carry: Any, dev: torch.device):
    """A function n -> ms of n replays of a graph captured over one link
    (warmed up once on the capture stream, as core/specstep.py's DecodeLoop
    captures the step). A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    capture = torch.cuda.graph(graph)
    side = capture.capture_stream
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(params, carry)
    torch.cuda.synchronize(dev)
    try:
        with capture:
            fn(params, carry)
    except RuntimeError as err:
        raise RuntimeError("capturing a profile_phases link in a CUDA graph failed") from err
    torch.cuda.current_stream(dev).wait_stream(side)

    def run(n: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run.graph = graph  # alive as long as the timer
    return run


@contextlib.contextmanager
def stopwatch(device, marks: list):
    """Append the time of the work the block enqueues to marks: on a CUDA
    device a (start, end) pair of CUDA events, read later by read_ms (no
    host sync here), else the host ms around the block."""
    if device is not None and torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        marks.append((start, end))
        return
    t0 = time.perf_counter()
    yield
    marks.append((time.perf_counter() - t0) * 1e3)


def read_ms(marks: list) -> List[float]:
    """The ms of stopwatch's marks, in order (waits for the card's events)."""
    out = []
    for m in marks:
        if isinstance(m, tuple):
            m[1].synchronize()
            m = m[0].elapsed_time(m[1])
        out.append(m)
    return out


def _mean_std(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "std": 0.0, "n": 0}
    m = sum(xs) / len(xs)
    var = sum((x - m) ** 2 for x in xs) / len(xs)
    return {"mean": m, "std": var ** 0.5, "n": len(xs)}


@dataclass
class StructuredProfiler:
    enabled: bool = False
    step_ms: List[float] = field(default_factory=list)
    prefill_ms: List[float] = field(default_factory=list)
    accept_hist: Counter = field(default_factory=Counter)
    run_metadata: Dict[str, Any] = field(default_factory=dict)
    # Per-phase step attribution (draft / verify / commit ms), filled by
    # Engine.profile_phases.
    phase_ms: Optional[Dict[str, Any]] = None
    # time_step's marks not read yet (stopwatch).
    _pending: List[Any] = field(default_factory=list)

    def record_step(self, ms: float, accepted: Optional[int] = None) -> None:
        if not self.enabled:
            return
        self.step_ms.append(ms)
        if accepted is not None:
            self.accept_hist[int(accepted)] += 1

    def record_prefill(self, ms: float) -> None:
        if self.enabled:
            self.prefill_ms.append(ms)

    @contextlib.contextmanager
    def time_step(self, device=None):
        """Time the work the block enqueues as one step: on a CUDA `device`
        between two CUDA events read later (flush), else by the host clock
        around the block."""
        if not self.enabled:
            yield
            return
        with stopwatch(device, self._pending):
            yield

    def flush(self) -> None:
        """Read time_step's marks into step_ms (waits for the card's last)."""
        self.step_ms += read_ms(self._pending)
        self._pending.clear()

    def summary(self) -> dict:
        self.flush()
        return {
            "enabled": self.enabled,
            "step_ms": _mean_std(self.step_ms),
            "prefill_ms": _mean_std(self.prefill_ms),
            "phase_ms": self.phase_ms,
            "acceptance_histogram": dict(sorted(self.accept_hist.items())),
            "memory": device_memory_stats().as_dict(),
            "run_metadata": self.run_metadata,
        }

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    @contextlib.contextmanager
    def trace(self, logdir: str):
        """A torch.profiler trace of the block (the card's kernels when CUDA
        is up), exported as a Chrome trace into logdir/trace.json."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
