"""Long-run serving stress harness (port of
llm_inference_lab_tpu/bench/stress.py).

Continuous admission churn through a ContinuousBatcher: requests arrive
over time with skewed prompt lengths and short and long budgets, so slots
retire and refill constantly; host RSS and device memory are tracked, and
poll latency is windowed so that degradation over time is measured. The
loop is JAX's order: ``step_chunk(poll_every)`` (under lazy pages a chunk
is at most ``poll_every`` steps), ``_retire_finished()`` on a fresh read of
the state, then admission.
"""

from __future__ import annotations

import resource
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher


@dataclass
class StressConfig:
    total_requests: int = 200
    n_slots: int = 4
    seed: int = 0
    # Skewed prompt lengths (characters; byte tokenizer => tokens): mostly
    # short with a heavy tail, like real traffic.
    prompt_len_lognorm: tuple = (4.0, 1.0)  # (mean, sigma) of ln(len)
    prompt_len_cap: int = 600
    # Mixed generation budgets; the small ones make retirement EOS-heavy.
    max_new_choices: tuple = (2, 4, 8, 16, 32)
    queue_low_water: int = 8  # submit more when queue drops below this
    submit_burst: int = 16
    window_polls: int = 10  # metrics window size, in admission polls
    max_wall_s: float = 600.0


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _device_mem_mb(device: torch.device) -> Optional[float]:
    """MB allocated on the card, or None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e6


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def run_stress(engine, cfg: StressConfig, batcher: Optional[ContinuousBatcher] = None
               ) -> Dict[str, Any]:
    """Drive a ContinuousBatcher (batcher, or one of cfg.n_slots over
    engine) under churn until `total_requests` complete. Returns a report
    with per-window latency and memory; the bounds are the caller's."""
    rng = np.random.default_rng(cfg.seed)
    b = batcher or ContinuousBatcher(engine, n_slots=cfg.n_slots)
    device = b.engine.device
    submitted = 0
    words = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")

    def submit_burst():
        nonlocal submitted
        n = min(cfg.submit_burst, cfg.total_requests - submitted)
        for _ in range(n):
            ln = int(min(cfg.prompt_len_cap,
                         rng.lognormal(*cfg.prompt_len_lognorm)))
            body = " ".join(rng.choice(words, size=max(1, ln // 6)))
            b.submit(body[: max(1, ln)],
                     max_new_tokens=int(rng.choice(cfg.max_new_choices)))
            submitted += 1

    submit_burst()
    b._admit_pending()

    windows: List[Dict[str, Any]] = []
    poll_times: List[float] = []
    polls = 0
    t_start = time.perf_counter()
    rss0, dev0 = _rss_mb(), _device_mem_mb(device)

    while len(b._done) < cfg.total_requests:
        if time.perf_counter() - t_start > cfg.max_wall_s:
            break
        t0 = time.perf_counter()
        b.step_chunk(b.poll_every)
        b._retire_finished()
        if (submitted < cfg.total_requests
                and b.scheduler.pending() < cfg.queue_low_water):
            submit_burst()
        b._admit_pending()
        poll_times.append(time.perf_counter() - t0)
        polls += 1
        if polls % cfg.window_polls == 0:
            recent = poll_times[-cfg.window_polls:]
            windows.append({
                "poll": polls,
                "done": len(b._done),
                "p50_ms": _pct(recent, 50) * 1e3,
                "p95_ms": _pct(recent, 95) * 1e3,
                "rss_mb": _rss_mb(),
                "device_mb": _device_mem_mb(device),
            })

    results = [b._done[rid].result for rid in sorted(b._done)]
    first = windows[0] if windows else {}
    last = windows[-1] if windows else {}
    wall = time.perf_counter() - t_start
    return {
        "completed": len(results),
        "submitted": submitted,
        "total_requested": cfg.total_requests,
        "decode_steps": b._steps,
        "polls": polls,
        "wall_s": wall,
        "tokens": int(sum(r["generated_tokens"] for r in results)),
        "tokens_per_sec": sum(r["generated_tokens"] for r in results) / wall
        if wall else 0.0,
        "all_nonempty": all(r["generated_tokens"] > 0 for r in results),
        "windows": windows,
        "first_window": first,
        "last_window": last,
        "rss_growth_mb": _rss_mb() - rss0,
        "device_mem_growth_mb": (
            (_device_mem_mb(device) - dev0) if dev0 is not None else None
        ),
        "latency_degradation": (
            last.get("p50_ms", 0.0) / max(first.get("p50_ms", 1e-9), 1e-9)
            if windows else 1.0
        ),
    }
