"""The K-sweep benchmark harness (port of
llm_inference_lab_tpu/bench/k_sweep.py).

A 10-prompt suite, one engine a K (built and warmed up at the measurement's
shapes before the timed iterations; its set-up seconds are kept apart),
batched iterations through generate_batch, a failure record a K, the
synthetic dry run (``EnvFlags(dry_run=True)``, JAX's SPECDX_DRY_RUN), CSV
and JSON results with the system and kernel-backend audit, and
throughput / acceptance plots when matplotlib imports.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import platform
import statistics
import subprocess
import time
from typing import Any, Dict, List, Optional

import torch

from llm_inference_lab_tpu_torch import resolve_device
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.ops import kernel_backends

# JAX's suite: short factual and creative prompts.
PROMPT_SUITE = [
    "The future of artificial intelligence is",
    "In a small village by the sea, there lived",
    "The most important scientific discovery of the century",
    "Climate change affects our planet by",
    "The recipe for a perfect day starts with",
    "Once upon a time in a distant galaxy",
    "The key to learning a new language is",
    "Modern computer architecture relies on",
    "The history of mathematics begins with",
    "A balanced approach to work and life means",
]


def system_info(device="cuda", flags: Optional[EnvFlags] = None) -> Dict[str, Any]:
    """JAX's keys from torch: torch_version where JAX has jax_version, the
    backend ("cuda" or "cpu"), the card's name and count (and on the card
    its power limit from nvidia-smi), what runs each op (kernel_backends),
    and the EnvFlags in force."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch_version": torch.__version__,
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "kernel_backends": kernel_backends(dev),
        "env_flags": dataclasses.asdict(flags or EnvFlags()),
    }
    if on_card:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return info


def _stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": float("nan"), "std": float("nan"), "median": float("nan")}
    return {
        "mean": statistics.fmean(xs),
        "std": statistics.pstdev(xs) if len(xs) > 1 else 0.0,
        "median": statistics.median(xs),
    }


def run_k_sweep(
    base_model: str = "gpt2",
    draft_model: Optional[str] = "distilgpt2",
    implementation: str = "fake",
    max_k: int = 4,
    max_new_tokens: int = 64,
    iterations: int = 3,
    batch_size: int = 0,
    policy: str = "longest_prefix",
    quantization: Optional[str] = None,
    output_dir: Optional[str] = None,
    seed: int = 0,
    prompts: Optional[List[str]] = None,
    *,
    device="cuda",
    flags: Optional[EnvFlags] = None,
    **config_fields: Any,
) -> Dict[str, Any]:
    """JAX's sweep over K = 1..max_k on `device`. flags: EnvFlags (dry_run,
    batch_size; the engines' too). config_fields: EngineConfig fields the
    sweep has no argument for (quantized_init, quantize_embed, max_seq_len,
    ...), the same in every K's engine. Each K's summary adds
    ``setup_s``: the engine's build and warm-up (its graph captures), kept
    out of the timed iterations."""
    flags = flags or EnvFlags()
    prompts = prompts or PROMPT_SUITE
    batch_size = batch_size or flags.batch_size  # the explicit argument wins
    if flags.dry_run:
        # Synthetic results without touching the device (JAX's numbers).
        summary = {
            f"k={k}": {
                "tokens_per_sec": {"mean": 100.0 / k, "std": 0.0, "median": 100.0 / k},
                "acceptance_rate": {"mean": 0.5, "std": 0.0, "median": 0.5},
                "dry_run": True,
            }
            for k in range(1, max_k + 1)
        }
        return {"system_info": system_info(device, flags), "summary_results": summary}

    summary: Dict[str, Any] = {}
    detailed: List[Dict[str, Any]] = []
    for k in range(1, max_k + 1):
        eng = None  # the last K's engine is freed before the next is built
        try:
            t0 = time.perf_counter()
            eng = Engine(
                EngineConfig(
                    base_model=base_model,
                    draft_model=draft_model,
                    implementation=implementation,
                    max_draft=k,
                    max_new_tokens=max_new_tokens,
                    policy=policy,
                    quantization=quantization,
                    seed=seed,
                    **config_fields,
                ),
                device=device,
                flags=flags,
            )
            # Warm up at the measurement's shapes: a decode loop is captured
            # per (batch, buffer length), so a mismatched warm-up would leave
            # a capture inside the first timed iteration.
            bs0 = batch_size or len(prompts)
            eng.generate_batch(prompts[:bs0], max_new_tokens=max_new_tokens)
            setup_s = time.perf_counter() - t0
            tok_s: List[float] = []
            agg_tok_s: List[float] = []
            acc: List[float] = []
            lat: List[float] = []
            for it in range(iterations):
                bs = batch_size or len(prompts)
                for i in range(0, len(prompts), bs):
                    rs = eng.generate_batch(prompts[i : i + bs])
                    for r in rs:
                        tok_s.append(r["tokens_per_sec"])
                        acc.append(r["acceptance_rate"])
                        lat.append(r["generation_time_ms"] / max(r["steps"], 1))
                        detailed.append(
                            {"k": k, "iteration": it, **{
                                key: r[key]
                                for key in (
                                    "batch_index", "generated_tokens", "tokens_per_sec",
                                    "acceptance_rate", "steps", "generation_time_ms",
                                )
                            }}
                        )
                    agg_tok_s.append(rs[0]["batch_metrics"]["aggregate_tokens_per_sec"])
            summary[f"k={k}"] = {
                "tokens_per_sec": _stats(tok_s),
                "aggregate_tokens_per_sec": _stats(agg_tok_s),
                "acceptance_rate": _stats(acc),
                "step_latency_ms": _stats(lat),
                "success_rate": 1.0,
                "setup_s": setup_s,
            }
        except Exception as e:  # JAX's failure record a K: a caller checks success_rate
            summary[f"k={k}"] = {
                "tokens_per_sec": _stats([]),
                "acceptance_rate": _stats([]),
                "success_rate": 0.0,
                "error": f"{type(e).__name__}: {e}",
            }

    results = {
        "system_info": system_info(device, flags),
        "config": {
            "base_model": base_model,
            "draft_model": draft_model,
            "implementation": implementation,
            "max_new_tokens": max_new_tokens,
            "iterations": iterations,
            "policy": policy,
            "quantization": quantization,
        },
        "summary_results": summary,
        "detailed_results": detailed,
    }
    if output_dir:
        save_results(results, output_dir)
    return results


def save_results(results: Dict[str, Any], output_dir: str) -> Dict[str, str]:
    """The JSON archive and JAX's CSV (one row a K), and the plots when
    matplotlib imports."""
    os.makedirs(output_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    backend = results["system_info"]["backend"]
    base = os.path.join(output_dir, f"specdx_{backend}_{stamp}")
    with open(base + ".json", "w") as f:
        json.dump(results, f, indent=2)
    with open(base + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(
            ["k", "tok_s_mean", "tok_s_std", "acceptance_mean", "acceptance_std",
             "step_latency_ms_mean", "success_rate"]
        )
        for key, row in results["summary_results"].items():
            w.writerow(
                [
                    key.split("=")[1],
                    row["tokens_per_sec"]["mean"],
                    row["tokens_per_sec"]["std"],
                    row["acceptance_rate"]["mean"],
                    row["acceptance_rate"]["std"],
                    row.get("step_latency_ms", {}).get("mean", ""),
                    row.get("success_rate", ""),
                ]
            )
    paths = {"json": base + ".json", "csv": base + ".csv"}
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return paths  # the plots are optional, as in JAX
    paths.update(create_plots(results, base))
    return paths


def create_plots(results: Dict[str, Any], base: str) -> Dict[str, str]:
    """Throughput-against-K and acceptance-against-K plots."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ks, tps, accs = [], [], []
    for key, row in sorted(results["summary_results"].items()):
        if row.get("success_rate", 0) or row.get("dry_run"):
            ks.append(int(key.split("=")[1]))
            tps.append(row["tokens_per_sec"]["mean"])
            accs.append(row["acceptance_rate"]["mean"])
    out = {}
    for name, ys, label in [
        ("throughput_vs_k", tps, "tokens/sec"),
        ("acceptance_vs_k", accs, "acceptance rate"),
    ]:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(ks, ys, marker="o")
        ax.set_xlabel("K (draft length)")
        ax.set_ylabel(label)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        path = f"{base}_{name}.png"
        fig.savefig(path, dpi=120)
        plt.close(fig)
        out[name] = path
    return out
