"""BenchmarkRunner: spec-decode against the non-speculative baseline (port
of llm_inference_lab_tpu/bench/run_bench.py).

Modes: "specdec" (the configured engine), "baseline" (the same engine with
draft_model=None) and "http" (a client of any OpenAI-compatible server: the
port's ``specdx-torch serve`` or another). Warm-up, then N iterations over
the prompts, with mean / median / std of latency, tok/s and acceptance.
The timings are the engine's result dicts' (``generation_time_ms`` and
``tokens_per_sec`` sync the card before they read the clock); the runner
times only HTTP round trips.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Dict, List, Optional

from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.core.engine import Engine


def _stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": float("nan"), "std": float("nan"), "median": float("nan")}
    return {
        "mean": statistics.fmean(xs),
        "std": statistics.pstdev(xs) if len(xs) > 1 else 0.0,
        "median": statistics.median(xs),
    }


class BenchmarkRunner:
    # HTTP mode: how long check_health polls, and whether requests go to
    # /v1/chat/completions (True) or /v1/completions (a caller may set both).
    health_timeout_s = 10.0
    http_chat = False

    def __init__(
        self,
        mode: str = "specdec",  # "specdec" | "baseline" | "http"
        config: Optional[EngineConfig] = None,
        warmup: int = 1,
        iterations: int = 5,
        server_url: Optional[str] = None,
        *,
        device="cuda",
        flags: Optional[EnvFlags] = None,
        **config_overrides: Any,
    ):
        """config (EngineConfig() when None) with config_overrides (None
        values skipped) builds the engine on `device` (none in http mode);
        flags: the engine's EnvFlags."""
        if mode not in ("specdec", "baseline", "http"):
            raise ValueError(f"unknown mode {mode!r}: specdec, baseline or http")
        self.mode = mode
        self.warmup = warmup
        self.iterations = iterations
        self.server_url = server_url
        self.device = device
        self.flags = flags
        cfg = (config or EngineConfig()).override(**config_overrides)
        if mode == "baseline":
            cfg = dataclasses.replace(cfg, draft_model=None)
        self.config = cfg
        self.engine = Engine(cfg, device=device, flags=flags) if mode != "http" else None

    def run(self, prompts: List[str], max_new_tokens: int = 64) -> Dict[str, Any]:
        if self.mode == "http":
            return self._run_http(prompts, max_new_tokens)
        eng = self.engine
        # Warm up at the measurement's shape: a decode loop is captured per
        # (batch, buffer length), and the buffer length follows
        # max_new_tokens.
        for p in prompts[:1] * self.warmup:
            eng.generate(p, max_new_tokens=max_new_tokens)
        lat, tok_s, acc = [], [], []
        for _ in range(self.iterations):
            for p in prompts:
                r = eng.generate(p, max_new_tokens=max_new_tokens)
                lat.append(r["generation_time_ms"])
                tok_s.append(r["tokens_per_sec"])
                acc.append(r["acceptance_rate"])
        return {
            "mode": self.mode,
            "latency_ms": _stats(lat),
            "tokens_per_sec": _stats(tok_s),
            "acceptance_rate": _stats(acc),
            "iterations": self.iterations,
            "n_prompts": len(prompts),
        }

    def compare_to_baseline(
        self, prompts: List[str], max_new_tokens: int = 64
    ) -> Dict[str, Any]:
        """Spec-decode against non-speculative decoding on the same target
        (its weights made anew from the config's seed)."""
        spec = self.run(prompts, max_new_tokens)
        base_runner = BenchmarkRunner(
            mode="baseline",
            config=self.config,
            warmup=self.warmup,
            iterations=self.iterations,
            device=self.device,
            flags=self.flags,
        )
        base = base_runner.run(prompts, max_new_tokens)
        speedup = (
            spec["tokens_per_sec"]["mean"] / base["tokens_per_sec"]["mean"]
            if base["tokens_per_sec"]["mean"]
            else float("nan")
        )
        return {"specdec": spec, "baseline": base, "speedup": speedup}

    # -- HTTP mode: health polling, per-request retries, completions and
    # chat/completions --

    def check_health(self, timeout_s: float = 10.0, interval_s: float = 0.5) -> bool:
        """Poll /health (falling back to /v1/models) until the server
        answers or the deadline passes."""
        import urllib.error
        import urllib.request

        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            for path in ("/health", "/v1/models"):
                try:
                    with urllib.request.urlopen(
                        f"{self.server_url}{path}", timeout=5
                    ) as resp:
                        if resp.status < 500:
                            return True
                except (urllib.error.URLError, OSError):
                    continue
            time.sleep(interval_s)
        return False

    def _http_one(
        self, prompt: str, max_new_tokens: int, chat: bool, retries: int = 3
    ) -> Dict[str, Any]:
        import urllib.error
        import urllib.request

        if chat:
            path = "/v1/chat/completions"
            payload = {
                "messages": [{"role": "user", "content": prompt}],
                "max_tokens": max_new_tokens,
            }
        else:
            path = "/v1/completions"
            payload = {"prompt": prompt, "max_tokens": max_new_tokens}
        body = json.dumps(payload).encode()
        last_err: Optional[str] = None
        for attempt in range(retries):
            req = urllib.request.Request(
                f"{self.server_url}{path}",
                data=body,
                headers={"Content-Type": "application/json"},
            )
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    data = json.loads(resp.read())
                ms = (time.perf_counter() - t0) * 1e3
                toks = data.get("usage", {}).get("completion_tokens")
                return {"ok": True, "latency_ms": ms, "completion_tokens": toks}
            except (urllib.error.URLError, OSError, ValueError) as e:
                last_err = f"{type(e).__name__}: {e}"
                time.sleep(0.5 * (attempt + 1))  # back off, then retry
        return {"ok": False, "error": last_err}

    def _run_http(self, prompts: List[str], max_new_tokens: int) -> Dict[str, Any]:
        """An OpenAI-compatible endpoint's client, with the health check and
        retries."""
        healthy = self.check_health(timeout_s=self.health_timeout_s)
        chat = self.http_chat
        lat, tok_s, failures = [], [], 0
        if healthy:
            for _ in range(self.iterations):
                for p in prompts:
                    r = self._http_one(p, max_new_tokens, chat)
                    if not r["ok"]:
                        failures += 1
                        continue
                    lat.append(r["latency_ms"])
                    if r.get("completion_tokens"):
                        tok_s.append(r["completion_tokens"] / (r["latency_ms"] / 1e3))
        total = self.iterations * len(prompts)
        return {
            "mode": "http",
            "healthy": healthy,
            "endpoint": "chat/completions" if chat else "completions",
            "latency_ms": _stats(lat),
            "tokens_per_sec": _stats(tok_s),
            "success_rate": (total - failures) / total if healthy and total else 0.0,
        }
