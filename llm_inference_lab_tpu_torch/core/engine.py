"""Engine: speculative-decoding generation on one device.

Port of llm_inference_lab_tpu/core/engine.py (``Engine.generate`` /
``generate_batch``, ``_enable_kv_ring`` and ``_build_results``) for the
ported slice: Llama, Gemma or Mistral target and draft (models/registry.py),
or the fake test model (``implementation="fake"``); vanilla drafting from a
draft model, ngram drafting from the token buffer, Medusa-lite and
EAGLE-lite drafting from the target's hidden state and tree speculation
(``draft_mode``; core/treespec.py); the five acceptance policies
(``policy``); the fixed, the host-side adaptive and the device-side adaptive
K controller (``controller``); greedy decoding or engine-level sampling;
weight-only int4/int8 with an optional int8 embedding/tied head, a
contiguous or paged KV cache (``kv_layout``) of the model dtype or int8
(``kv_quantization``), single-shot or chunked prefill (``prefill_chunk``)
and the rolling-buffer cache (``kv_ring``). Prompt bucketing, the
out-of-vocab clamp and the result keys follow the JAX engine. The serving
path (core/batching.py ContinuousBatcher) drives the same step and reads
``encode``, ``is_spec``, ``_max_k``, ``eos_token_id``, ``flags``,
``controller``, ``_step``, ``_step_in_place`` and ``graph_pool`` from here,
and ``decode`` hands the final state (committed tokens and caches) to a
caller such as core/kv_verify.py.

Decoding, as in JAX: with a fixed or the device-side adaptive controller,
by default the decode loop of core/specstep.py (``make_decode_loop``; JAX's
device-side while_loop) in chunks of CUDA-graph replays on the card, of
in-place steps on the CPU, with one host read after each chunk. The engine
keeps one decode state and its loop per shape (batch, buffer length),
resets it in place (its key from the call's seed), prefills into it
(eagerly) and replays. ``EnvFlags(sync_steps=True)`` gives JAX's observed
loop instead: a fresh state, one functional step at a time and one
``active.any()`` poll after each, the eager reference on the card. The host
adaptive controller picks K before every step, as JAX's observed loop does:
one step at a time with the one-step-delayed poll, each K its own step (on
the card a one-step graph captured once a K and shape, in the engine's
pool; the functional step under sync_steps).

The device defaults to "cuda"; asking for it on a machine without CUDA
raises (pass device="cpu" for the plain PyTorch versions of every op).
"""

from __future__ import annotations

import copy
import resource
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from llm_inference_lab_tpu_torch import resolve_device
from llm_inference_lab_tpu_torch.config import HEAD_MODES, EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.core.controllers import (
    AdaptiveDeviceKController,
    AdaptiveKController,
    create_controller,
)
from llm_inference_lab_tpu_torch.core.policies import create_policy
from llm_inference_lab_tpu_torch.core.specstep import (
    DecodeLoop,
    make_baseline_step,
    make_decode_loop,
    make_prefill,
    make_spec_step,
)
from llm_inference_lab_tpu_torch.core.state import DecodeState, assign, init_state, reset_state
from llm_inference_lab_tpu_torch.core.treespec import TreeConfig, make_tree_spec_step
from llm_inference_lab_tpu_torch.models import registry
from llm_inference_lab_tpu_torch.ops.quant import quantize_params
from llm_inference_lab_tpu_torch.utils.tokenizer import ByteTokenizer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None, *, device="cuda",
                 flags: Optional[EnvFlags] = None, target_params: Optional[dict] = None,
                 draft_params: Optional[dict] = None):
        """target_params / draft_params: the models' params (e.g. carried over
        from the JAX package by convert.params_from_jax); random init from
        cfg.seed when absent. In the medusa and tree modes draft_params is
        the heads' {"medusa_proj": [H, D, D]} (JAX's Engine._draft_params),
        made from cfg.medusa's head_init when absent. flags: EnvFlags
        (sync_steps=True for the host loop)."""
        cfg = config or EngineConfig()
        cfg.validate()
        self.config = cfg
        self.flags = flags or EnvFlags()
        self.device = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        qinit = cfg.quantization if (cfg.quantized_init and cfg.quantization) else None
        model_kw = dict(device=self.device, dtype=dtype, quantized_init=qinit,
                        quantize_embed=cfg.quantize_embed)
        fake = cfg.implementation == "fake"
        self.target = registry.create(cfg.base_model, implementation=cfg.implementation,
                                      seed=cfg.seed, params=target_params, **model_kw)
        # ngram drafts from the token buffer, the head modes from the target's
        # hidden state: no draft model, no draft cache.
        self.draft = None
        if cfg.draft_model is not None and cfg.draft_mode == "vanilla":
            # The fake target's draft misses 15% of its predictions.
            self.draft = registry.create("fake-draft" if fake else cfg.draft_model,
                                         implementation=cfg.implementation, seed=cfg.seed + 1,
                                         params=draft_params, **model_kw)
        if cfg.quantization and not cfg.quantized_init:
            for m in (self.target, self.draft):
                if m is not None:
                    m.params = quantize_params(m.params, cfg.quantization,
                                               include_embed=cfg.quantize_embed)
        self._weights_source = ("fake" if fake else
                                "given" if target_params is not None else "random")
        self.tokenizer = ByteTokenizer()
        self.eos_token_id = (cfg.eos_token_id if cfg.eos_token_id is not None
                             else self.tokenizer.eos_token_id)
        # The KV element type both caches use (JAX engine.py reads
        # kv_quantization the same way): None keeps the model dtype.
        self.kv_dtype = torch.int8 if cfg.kv_quantization == "int8" else None
        self.is_spec = self.draft is not None or cfg.draft_mode != "vanilla"
        self.policy_fn = create_policy(cfg.policy)
        self.controller = create_controller(cfg.controller, k=cfg.max_draft,
                                            **cfg.controller_params)
        # The largest K any controller setting can ask for sizes the buffers.
        self._max_k = max(getattr(self.controller, "max_k", 0), cfg.max_draft)
        self.head_mode = cfg.draft_mode in HEAD_MODES
        self.tree = (TreeConfig(tuple(int(b) for b in cfg.tree.get("branching", [3, 2])))
                     if cfg.draft_mode == "tree" else None)
        self._draft_params = self._head_params(draft_params, dtype)
        if self.tree is not None:
            # The verify chunk writes num_nodes + 1 cache rows a step: the
            # buffers' headroom is the tree's, not max_draft's.
            self._max_k = self.tree.num_nodes + 1
        self.host_adaptive = self.is_spec and isinstance(self.controller, AdaptiveKController)
        # The step of the decode loop: at cfg.max_draft, or at max_k with the
        # device controller's per-lane K inside it.
        self._k = (self.controller.max_k if isinstance(self.controller, AdaptiveDeviceKController)
                   else cfg.max_draft)
        self._step, self._step_in_place = self._build_step(self._k), self._build_step(
            self._k, in_place=True)
        self._steps_by_k: Dict[int, Any] = {}  # the host adaptive controller's steps
        # The decode loops' graphs of this engine share one memory pool: they
        # never run at once.
        self.graph_pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                           else None)
        self._decode_states: Dict[Tuple[int, int], Tuple[DecodeState, DecodeLoop]] = {}
        # The host adaptive controller's one-step loops, by (B, max_len, K).
        self.adaptive_loops: Dict[Tuple[int, int, int], DecodeLoop] = {}
        self.polls = 0  # host reads of the last decode
        if cfg.kv_ring:
            self._enable_kv_ring()
        self._prefill = make_prefill(self.target, self.draft, chunk=cfg.prefill_chunk,
                                     hidden=self.head_mode)

    def _head_params(self, given: Optional[dict], dtype: torch.dtype) -> Optional[dict]:
        """The Medusa heads of the medusa and tree modes ({"medusa_proj":
        [H, D, D]}, H = the largest K or the tree's depth), JAX's
        _draft_params: the given ones, or identity projections ("tie" or
        "copy": the target's own head) plus, for "random", N(0, 0.02^2)
        noise from a generator seeded with seed + 7 (JAX's PRNG cannot be
        reproduced: carry its heads over to compare). None in every other
        mode."""
        cfg = self.config
        if cfg.draft_mode not in ("medusa", "tree"):
            return None
        if given is not None:
            return {"medusa_proj": given["medusa_proj"].to(self.device, dtype)}
        H = self.tree.depth if self.tree is not None else self._max_k
        D = self.target.config.d_model
        proj = torch.eye(D, dtype=torch.float32, device=self.device).expand(H, D, D)
        if cfg.medusa.get("head_init", "tie") == "random":
            g = torch.Generator(device=self.device).manual_seed(cfg.seed + 7)
            proj = proj + 0.02 * torch.randn((H, D, D), generator=g, device=self.device)
        return {"medusa_proj": proj.to(dtype).contiguous()}

    def _build_step(self, k: int, in_place: bool = False):
        """The step at K = k (the baseline step when not speculative; the
        tree's step, which has no K, in tree mode)."""
        cfg = self.config
        samp = dict(greedy=cfg.greedy, temperature=cfg.temperature, top_k=cfg.top_k,
                    top_p=cfg.top_p, min_p=cfg.min_p, eos_token_id=self.eos_token_id,
                    in_place=in_place)
        if not self.is_spec:
            return make_baseline_step(self.target, **samp)
        if self.tree is not None:
            return make_tree_spec_step(self.target, self.tree, draft_params=self._draft_params,
                                       **samp)
        adaptive = isinstance(self.controller, AdaptiveDeviceKController)
        return make_spec_step(
            self.target, self.draft, k=k, policy_fn=self.policy_fn,
            policy_params=cfg.policy_params, draft_temperature_scale=cfg.draft_temperature_scale,
            draft_mode=cfg.draft_mode, ngram_cfg=cfg.ngram,
            adaptive_cfg=self.controller.adaptive_cfg() if adaptive else None,
            draft_params=self._draft_params, medusa_cfg=cfg.medusa, eagle_cfg=cfg.eagle, **samp)

    def _step_at(self, k: int):
        """(functional, in place) steps at K = k, built once a K."""
        if k not in self._steps_by_k:
            self._steps_by_k[k] = (self._build_step(k), self._build_step(k, in_place=True))
        return self._steps_by_k[k]

    def _enable_kv_ring(self) -> None:
        """Ring the contiguous KV cache of uniform sliding-window models: slot
        = position mod R with R = round_up(window + chunk + K + 2, 128), so a
        write (at position p, clobbering p - R) never reaches a row still
        inside a live query's window. Applied per model: a model without a
        window, or with Gemma-2's alternating one, keeps its plain cache, and
        so does one whose ring would not be shorter than max_seq_len."""
        cfg = self.config
        for model in (self.target, self.draft):
            if model is None:
                continue
            mc = model.config
            if mc.sliding_window is None or mc.alt_window:
                continue
            R = _round_up(mc.sliding_window + cfg.prefill_chunk + self._max_k + 2, 128)
            if R < cfg.max_seq_len:
                model.config = replace(mc, kv_ring_len=R)

    def generate(self, prompt: str, seed: Optional[int] = None) -> Dict[str, Any]:
        return self.generate_batch([prompt], seed=seed)[0]

    def encode(self, prompt: str, max_new: int, max_seq_len: int) -> List[int]:
        """Prompt ids, cut to leave room for max_new tokens and the step's
        K+2 scratch rows in max_seq_len, each clamped into the vocabulary
        (a trust-boundary clamp, always on: an out-of-vocab id would index
        past the embedding table)."""
        vocab = self.target.config.vocab_size
        ids = self.tokenizer.encode(prompt)[: max_seq_len - max_new - self._max_k - 2]
        return [min(max(t, 0), vocab - 1) for t in ids]

    def generate_batch(self, prompts: List[str],
                       seed: Optional[int] = None) -> List[Dict[str, Any]]:
        """One result dict per prompt. seed: the key of the call's sampling
        (the config's seed when None)."""
        with torch.inference_mode():
            return self._build_results(*self._decode(prompts, seed))

    @torch.inference_mode()
    def decode(self, prompts: List[str],
               seed: Optional[int] = None) -> Tuple[DecodeState, np.ndarray, float, float]:
        """Prefill the prompts and decode them to the end. Returns the final
        state (the caller's own: a later call does not change it), the prompt
        lengths, and the decode and total wall seconds."""
        state, plens, decode_s, total_s = self._decode(prompts, seed)
        if not self.flags.sync_steps:  # the engine's own decode state: a copy
            state = copy.deepcopy(state)
        return state, plens, decode_s, total_s

    def _decode(self, prompts: List[str],
                seed: Optional[int]) -> Tuple[DecodeState, np.ndarray, float, float]:
        max_new = self.config.max_new_tokens
        seed = self.config.seed if seed is None else seed
        block, plens, max_len = self._prompt_block(prompts)
        dev = self.device
        t_start = time.perf_counter()
        prompt = torch.from_numpy(block).to(dev), torch.from_numpy(plens).to(dev)
        if self.flags.sync_steps:
            state = self._prefill(self._init_state(len(plens), max_len, seed), *prompt)
        else:
            state, loop = self._decode_state(len(plens), max_len, seed)
            assign(state, self._prefill(state, *prompt))
        self._sync()
        t_decode = time.perf_counter()
        # Each active step commits >= 1 token, so max_new + 1 steps always
        # finish.
        if self.host_adaptive:
            state = self._run_adaptive(state, max_new)
        elif self.flags.sync_steps:
            # One host poll per step: active.any().
            self.polls = 0
            for _ in range(max_new + 1):
                self.polls += 1
                if not bool(state.active.any()):
                    break
                state = self._step(state)
        else:
            self._run_loop(loop, state, plens, max_new)
        self._sync()
        decode_s = time.perf_counter() - t_decode
        total_s = time.perf_counter() - t_start
        return state, plens, decode_s, total_s

    def _prompt_block(self, prompts: List[str]) -> Tuple[np.ndarray, np.ndarray, int]:
        """The right-padded prompt block [B, P], the prompt lengths and the
        buffer length: P a multiple of 32 (and of prefill_chunk when the
        prompt is longer than a chunk), the buffer P + max_new + K + 2
        rounded up to 128."""
        cfg = self.config
        enc = [self.encode(p, cfg.max_new_tokens, cfg.max_seq_len) for p in prompts]
        plens = np.array([len(e) for e in enc], np.int32)
        P = _round_up(max(int(plens.max()), 1), 32)
        if cfg.prefill_chunk and P > cfg.prefill_chunk:
            P = _round_up(P, cfg.prefill_chunk)  # the chunks tile the prompt block
        block = np.zeros((len(enc), P), np.int32)
        for i, e in enumerate(enc):
            block[i, : len(e)] = e
        return block, plens, _round_up(P + cfg.max_new_tokens + self._max_k + 2, 128)

    def _init_state(self, B: int, max_len: int, seed: Optional[int] = None) -> DecodeState:
        cfg = self.config
        return init_state(self.target, self.draft, B, max_len, self.device,
                          max_new_tokens=cfg.max_new_tokens, paged=cfg.kv_layout == "paged",
                          page_size=cfg.kv_page_size, kv_dtype=self.kv_dtype,
                          seed=cfg.seed if seed is None else seed, init_k=self.controller.k)

    def _decode_state(self, B: int, max_len: int,
                      seed: Optional[int] = None) -> Tuple[DecodeState, DecodeLoop]:
        """The decode state of this shape, reset to init_state's values, and
        its loop (captured at its first call)."""
        seed = self.config.seed if seed is None else seed
        held = self._decode_states.get((B, max_len))
        if held is None:
            held = (self._init_state(B, max_len, seed),
                    make_decode_loop(self._step_in_place, pool=self.graph_pool))
            self._decode_states[(B, max_len)] = held
        else:
            reset_state(held[0], self.config.max_new_tokens, seed, self.controller.k)
        return held

    def _run_loop(self, loop: DecodeLoop, state: DecodeState, plens: np.ndarray,
                  max_new: int) -> None:
        """Chunks of loop replays, one host read of (steps, active, lengths)
        after each, until no lane is active or max_new + 1 steps ran (JAX's
        max_steps). A chunk is ceil(largest remaining budget / (K + 1)) steps
        (a tree's depth + 1): a step commits at most that many tokens, so no
        step runs past the end unless a lane hits EOS or the buffer end, or
        commits fewer."""
        per_step = (self.tree.depth + 1 if self.tree is not None
                    else self._k + 1 if self.is_spec else 1)
        B = len(plens)
        steps, active, lengths = 0, plens > 0, plens.astype(np.int64)
        self.polls = 0
        while active.any() and steps < max_new + 1:
            remaining = int((plens + max_new - lengths)[active].max())
            loop(state, min(max(-(-remaining // per_step), 1), max_new + 1 - steps))
            polled = torch.cat([state.steps[None], state.active.to(torch.int32),
                                state.lengths]).cpu().numpy()
            self.polls += 1
            steps, active, lengths = int(polled[0]), polled[1:B + 1].astype(bool), polled[B + 1:]

    def _run_adaptive(self, state: DecodeState, max_new: int) -> DecodeState:
        """JAX's observed loop under the host adaptive controller: before each
        step the controller picks K; after it the sums (proposed, accepted,
        any active) of the step before are read (one step of lag, so the
        read overlaps the step on the card) and fed to the controller, and
        the loop ends when they show no active lane. So it runs one step
        after the last lane finished, which changes nothing (the state's
        ``steps`` does not count it; JAX's result counts it). Each step is
        the functional step at K under sync_steps, else one replay of the
        one-step loop of K over the engine's decode state (on the card a
        graph captured at K's first step, in the engine's pool)."""
        ctrl = self.controller
        B, max_len = state.tokens.shape
        on_card = state.tokens.is_cuda
        pending = None
        prev_prop = prev_acc = 0
        self.polls = 0
        for step_i in range(max_new + 1):
            k = ctrl.get_k(step_i)
            if self.flags.sync_steps:
                state = self._step_at(k)[0](state)
            else:
                loop = self.adaptive_loops.get((B, max_len, k))
                if loop is None:
                    loop = make_decode_loop(self._step_at(k)[1], pool=self.graph_pool)
                    self.adaptive_loops[(B, max_len, k)] = loop
                loop(state, 1)
            if pending is not None:
                if on_card:
                    pending[1].synchronize()
                prop, acc, act = (int(x) for x in pending[0])
                self.polls += 1
                ctrl.update(prop - prev_prop, acc - prev_acc)
                prev_prop, prev_acc = prop, acc
                if not act:
                    break
            sums = torch.stack([state.proposed.sum(), state.accepted.sum(),
                                state.active.any().to(state.proposed.dtype)])
            if on_card:
                host = torch.empty(3, dtype=sums.dtype, pin_memory=True)
                host.copy_(sums, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                pending = (host, done)
            else:
                pending = (sums, None)
        return state

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
        steps = int(state.steps)
        tokens = state.tokens.cpu().numpy()
        lengths = state.lengths.cpu().numpy()
        logprobs = state.token_logprobs.cpu().numpy()
        proposed = state.proposed.cpu().numpy()
        accepted = state.accepted.cpu().numpy()
        bonus = state.bonus.cpu().numpy()
        mem = self._memory()
        controller = self.controller.info()
        if isinstance(self.controller, AdaptiveDeviceKController):
            # The device controller's final per-lane state (one read, after
            # the decode).
            ck, ema = state.ctrl_k.cpu().tolist(), state.acc_ema.cpu().tolist()
            controller |= {"final_k": ck[0] if len(ck) == 1 else ck,
                           "recent_acceptance": (ema[0] if len(ema) == 1
                                                 else [round(x, 4) for x in ema])}
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
                "steps": steps,
                "policy": cfg.policy,
                "controller": controller,
                "impl": cfg.implementation,
                "device": str(self.device),
                "dtype": cfg.dtype,
                "quantization": cfg.quantization,
                "kv_quantization": cfg.kv_quantization,
                "base_model": cfg.base_model,
                "draft_model": cfg.draft_model,
                "draft_mode": cfg.draft_mode,
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
