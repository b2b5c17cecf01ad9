"""Engine: speculative-decoding generation on one device.

Port of llm_inference_lab_tpu/core/engine.py (``Engine.generate`` /
``generate_batch`` and ``_build_results``) for the ported slice: Llama
target and draft, vanilla drafting at a fixed K, greedy longest_prefix
acceptance, weight-only int4/int8 with an optional int8 embedding/tied head,
a contiguous KV cache. Prompt bucketing, the out-of-vocab clamp and the
result keys follow the JAX engine.

The device defaults to "cuda"; asking for it on a machine without CUDA
raises (pass device="cpu" for the plain PyTorch versions of every op).
"""

from __future__ import annotations

import resource
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llm_inference_lab_tpu_torch import resolve_device
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.specstep import (
    make_baseline_step,
    make_prefill,
    make_spec_step,
)
from llm_inference_lab_tpu_torch.core.state import DecodeState, init_state
from llm_inference_lab_tpu_torch.models import llama
from llm_inference_lab_tpu_torch.ops.quant import quantize_params
from llm_inference_lab_tpu_torch.utils.tokenizer import ByteTokenizer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None, *, device="cuda",
                 target_params: Optional[dict] = None, draft_params: Optional[dict] = None):
        """target_params / draft_params: the models' params (e.g. carried over
        from the JAX package by convert.params_from_jax); random init from
        cfg.seed when absent."""
        cfg = config or EngineConfig()
        cfg.validate()
        self.config = cfg
        self.device = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        qinit = cfg.quantization if (cfg.quantized_init and cfg.quantization) else None
        model_kw = dict(device=self.device, dtype=dtype, quantized_init=qinit,
                        quantize_embed=cfg.quantize_embed)
        self.target = llama.create(cfg.base_model, seed=cfg.seed, params=target_params,
                                   **model_kw)
        self.draft = None
        if cfg.draft_model is not None:
            self.draft = llama.create(cfg.draft_model, seed=cfg.seed + 1, params=draft_params,
                                      **model_kw)
        if cfg.quantization and not cfg.quantized_init:
            for m in (self.target, self.draft):
                if m is not None:
                    m.params = quantize_params(m.params, cfg.quantization,
                                               include_embed=cfg.quantize_embed)
        self._weights_source = "given" if target_params is not None else "random"
        self.tokenizer = ByteTokenizer()
        self.eos_token_id = (cfg.eos_token_id if cfg.eos_token_id is not None
                             else self.tokenizer.eos_token_id)
        self.is_spec = self.draft is not None
        self._max_k = cfg.max_draft
        if self.is_spec:
            self._step = make_spec_step(self.target, self.draft, k=cfg.max_draft,
                                        eos_token_id=self.eos_token_id)
        else:
            self._step = make_baseline_step(self.target, eos_token_id=self.eos_token_id)
        self._prefill = make_prefill(self.target, self.draft)

    def generate(self, prompt: str) -> Dict[str, Any]:
        return self.generate_batch([prompt])[0]

    @torch.inference_mode()
    def generate_batch(self, prompts: List[str]) -> List[Dict[str, Any]]:
        cfg = self.config
        max_new = cfg.max_new_tokens
        B = len(prompts)
        enc = [self.tokenizer.encode(p)[: cfg.max_seq_len - max_new - self._max_k - 2]
               for p in prompts]
        # Trust-boundary clamp, always on: an out-of-vocab id would index
        # past the embedding table.
        vocab = self.target.config.vocab_size
        enc = [[min(max(t, 0), vocab - 1) for t in e] for e in enc]
        plens = np.array([len(e) for e in enc], np.int32)
        P = _round_up(max(int(plens.max()), 1), 32)
        max_len = _round_up(P + max_new + self._max_k + 2, 128)
        block = np.zeros((B, P), np.int32)
        for i, e in enumerate(enc):
            block[i, : len(e)] = e

        dev = self.device
        t_start = time.perf_counter()
        state = init_state(self.target, self.draft, B, max_len, dev, max_new_tokens=max_new)
        state = self._prefill(state, torch.from_numpy(block).to(dev),
                              torch.from_numpy(plens).to(dev))
        self._sync()
        t_decode = time.perf_counter()
        # Each active step commits >= 1 token, so max_new + 1 steps always
        # finish. One host poll per step: active.any().
        while state.steps < max_new + 1 and bool(state.active.any()):
            state = self._step(state)
        self._sync()
        decode_s = time.perf_counter() - t_decode
        total_s = time.perf_counter() - t_start
        return self._build_results(state, plens, decode_s, total_s)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _memory(self) -> Dict[str, Any]:
        on_card = self.device.type == "cuda"
        return {
            "device_mem_mb": torch.cuda.memory_allocated(self.device) / 1e6 if on_card else None,
            "device_peak_mb": (torch.cuda.max_memory_allocated(self.device) / 1e6
                               if on_card else None),
            "mem_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        }

    def _build_results(self, state: DecodeState, plens: np.ndarray, decode_s: float,
                       total_s: float) -> List[Dict[str, Any]]:
        cfg = self.config
        tokens = state.tokens.cpu().numpy()
        lengths = state.lengths.cpu().numpy()
        logprobs = state.token_logprobs.cpu().numpy()
        proposed = state.proposed.cpu().numpy()
        accepted = state.accepted.cpu().numpy()
        bonus = state.bonus.cpu().numpy()
        mem = self._memory()
        B = len(plens)
        total_generated = int((lengths - plens).sum())
        results = []
        for b in range(B):
            gen_ids = tokens[b, plens[b]: lengths[b]].tolist()
            text_ids = [t for t in gen_ids if t != self.eos_token_id]
            n_gen = len(gen_ids)
            prop_b, acc_b = int(proposed[b]), int(accepted[b])
            results.append({
                "text": self.tokenizer.decode(text_ids),
                "generated_tokens": n_gen,
                "generated_ids": gen_ids,
                "token_logprobs": [round(float(x), 6) for x in logprobs[b, plens[b]: lengths[b]]],
                "prompt_logprobs": [None] + [round(float(x), 6)
                                             for x in logprobs[b, 1: plens[b]]],
                "top_logprobs": None,
                "latency_ms": total_s * 1e3,
                "generation_time_ms": decode_s * 1e3,
                "proposed": prop_b,
                "accepted": acc_b,
                "bonus_tokens": int(bonus[b]),
                "acceptance_rate": acc_b / prop_b if prop_b else 0.0,
                "tokens_per_sec": n_gen / decode_s if decode_s > 0 else 0.0,
                "steps": state.steps,
                "policy": "longest_prefix",
                "controller": {"type": "fixed", "k": cfg.max_draft},
                "impl": "hf",
                "device": str(self.device),
                "dtype": cfg.dtype,
                "quantization": cfg.quantization,
                "base_model": cfg.base_model,
                "draft_model": cfg.draft_model,
                "draft_mode": "vanilla",
                "weights_source": self._weights_source,
                "batch_index": b,
                "batch_size": B,
                "batch_metrics": {
                    "aggregate_tokens_per_sec": (total_generated / decode_s
                                                 if decode_s > 0 else 0.0),
                    "total_generated": total_generated,
                },
                **mem,
            })
        return results
