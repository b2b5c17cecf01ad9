"""Engine: speculative-decoding generation on one device.

Port of llm_inference_lab_tpu/core/engine.py (``Engine.generate`` /
``generate_batch``, ``_enable_kv_ring`` and ``_build_results``) for the
ported slice: a target and draft of any of the eight families
(models/registry.py; weights from the local HF cache when it holds the
preset's snapshot, as JAX's factory prefers them), or the fake test model (``implementation="fake"``); vanilla drafting from a
draft model, ngram drafting from the token buffer, Medusa-lite and
EAGLE-lite drafting from the target's hidden state and tree speculation
(``draft_mode``; core/treespec.py); the five acceptance policies
(``policy``); the fixed, the host-side adaptive and the device-side adaptive
K controller (``controller``); greedy decoding or engine-level sampling;
static penalties, per-request sampling (each slot's values in the decode
state, ``sampling_defaults`` without a request's own) and top-N logprobs
(``top_logprobs`` in each result); grammar-constrained decoding and forced
tool calls (``constrain``, ``tools``: the grammar's token tables compiled
once at construction, ``response_format`` a call);
multi-LoRA (``lora_adapters``, ``cfg.lora_paths``: the adapters stacked
into one pack in the target's layers, ``lora_names`` name -> id, a call's
``adapter`` every lane's id in the decode state); sentence embeddings
(``embed``: one eager prefill-shaped forward of the target, pooled in f32);
weight-only int4/int8 with an optional int8 or int4 embedding/tied head, a
contiguous or paged KV cache (``kv_layout``) of the model dtype or int8
(``kv_quantization``), single-shot or chunked prefill (``prefill_chunk``)
and the rolling-buffer cache (``kv_ring``). Prompt bucketing, the
out-of-vocab clamp and the result keys follow the JAX engine. The serving
path (core/batching.py ContinuousBatcher) drives the same step and reads
``encode``, ``is_spec``, ``_max_k``, ``eos_token_id``, ``flags``,
``controller``, ``_step``, ``_step_in_place``, ``_plain``, ``_fsm_steps``,
``constrain_tables``, ``_resolve_fsm_initial`` and ``graph_pool`` from
here, and ``decode`` hands the final state (committed tokens and caches) to a
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
pool; the functional step under sync_steps). The profiler
(``self.profiler``, metrics/profiler.py StructuredProfiler: on under
``cfg.profile``, the one switch for JAX's SPECDX_PROFILE and
SPECDX_DETAILED_METRICS) takes
generate through the same observed loop (JAX engine.py:828-880): it records
the prefill's ms, each step's ms (CUDA events, read after the loop) and its
accepted drafts, and fills ``phase_ms`` once an engine with
``profile_phases`` (draft, verify and commit ms of the step, each the slope
of a CUDA graph's replays on the card).

An engine built with a grammar (``constrain`` or ``tools``) holds the
constrained step beside the unconstrained one (JAX skips the mask with a
``lax.cond``; a graph cannot branch). A call whose grammar key
(``response_format``, or the deployment's default: ``constrain``'s, none
under ``tools``) selects an initial state replays the constrained step's
loop over the same decode state; any other replays the unconstrained one, so
its ids and step time are those of an engine without tables.

Under a mesh (``mesh=``, or ``cfg.mesh_shape`` over the initialised world;
parallel/): on the model axis each model is loaded whole and replaced by
this rank's share (parallel/sharding.py, Megatron order; the draft only
with ``shard_draft`` and when its KV heads split), and the decode loops
run their in-place step eagerly, never captured: a graph cannot hold a
gloo collective's host hop, and capturing NCCL collectives waits for a
second card. On the data axis alone each rank captures as in one process.
The engine decides this once, at construction (``eager_loops``).
``generate_batch`` splits the prompts over the data axis and returns every
result on every rank.

The device defaults to "cuda"; asking for it on a machine without CUDA
raises (pass device="cpu" for the plain PyTorch versions of every op).
"""

from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from llm_inference_lab_tpu_torch import resolve_device
from llm_inference_lab_tpu_torch.config import HEAD_MODES, EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.constrain import runtime as fsm
from llm_inference_lab_tpu_torch.constrain.jsonfsm import (
    compile_token_tables,
    json_char_automaton,
    token_bytes_of,
)
from llm_inference_lab_tpu_torch.constrain.regex import build_regex_automaton
from llm_inference_lab_tpu_torch.constrain.schema import build_schema_automaton
from llm_inference_lab_tpu_torch.constrain.tools import build_tools_automaton
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
from llm_inference_lab_tpu_torch.metrics.profiler import (
    StructuredProfiler,
    device_memory_stats,
    read_ms,
    slope_chain_ms,
    stopwatch,
)
from llm_inference_lab_tpu_torch.models import registry
from llm_inference_lab_tpu_torch.models.lora import Adapter, build_pack, load_peft_adapter
from llm_inference_lab_tpu_torch.ops.quant import quantize_params
from llm_inference_lab_tpu_torch.parallel.mesh import Mesh, make_mesh
from llm_inference_lab_tpu_torch.parallel.sharding import shard_model
from llm_inference_lab_tpu_torch.utils.tokenizer import ByteTokenizer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# Steps a chunk of a constrained call's replays at most (Engine._run_loop).
FSM_CHUNK = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plain_rows(values: Dict[str, float]) -> bool:
    """A row's sampling values (sampling_defaults' keys) are greedy with no
    penalty: the plain greedy step gives it what the per-request step
    does (the bias is the caller's to check)."""
    return (values["temperature"] <= 0.0 and values["rep_penalty"] == 1.0
            and values["presence_penalty"] == 0.0 and values["freq_penalty"] == 0.0)


def top_logprobs(tops: Tuple[np.ndarray, np.ndarray], row: int, start: int,
                 end: int) -> List[List[Dict[str, Any]]]:
    """Positions start .. end - 1 of a row of the top-N buffers (ids, log
    probs [B, max_len, N] on the host) as JAX's result lists them: for each
    position N {"id", "logprob"} dicts, the most likely first."""
    ids, lps = tops
    return [[{"id": int(i), "logprob": round(float(lp), 6)} for i, lp in zip(ids[row, p],
                                                                             lps[row, p])]
            for p in range(start, end)]


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None, *, device="cuda",
                 flags: Optional[EnvFlags] = None, target_params: Optional[dict] = None,
                 draft_params: Optional[dict] = None,
                 lora_adapters: Optional[List[Adapter]] = None, mesh: Optional[Mesh] = None):
        """target_params / draft_params: the models' params (e.g. carried over
        from the JAX package by convert.params_from_jax); random init from
        cfg.seed when absent. In the medusa and tree modes draft_params is
        the heads' {"medusa_proj": [H, D, D]} (JAX's Engine._draft_params),
        made from cfg.medusa's head_init when absent. flags: EnvFlags
        (sync_steps=True for the host loop). lora_adapters: models/lora.py
        Adapters, stacked with cfg.lora_paths' (after them) into the
        target's LoRA pack, addressed by name (lora_names). mesh: this
        rank's parallel/mesh.py Mesh (None: one made from cfg.mesh_shape
        when it is set, else no mesh; given with a cfg.mesh_shape, the two
        must agree); the params given are the whole models', which the
        engine shards."""
        cfg = config or EngineConfig()
        cfg.validate()
        self.config = cfg
        self.flags = flags or EnvFlags()
        self.device = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        qinit = cfg.quantization if (cfg.quantized_init and cfg.quantization) else None
        # quantize_embed carries the bit width to a quantized init (JAX's
        # engine does the same): True an int8 table, 4 an EmbedQuant4.
        model_kw = dict(device=self.device, dtype=dtype, quantized_init=qinit,
                        quantize_embed=((4 if cfg.embed_bits == 4 else True)
                                        if cfg.quantize_embed else False))
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
                if m is not None and m.config.moe:
                    # JAX's quantize_params quantizes a real Mixtral's router
                    # (a 3-D leaf past min_size), which its routing cannot
                    # read: no quantized MoE in either package (a quantized
                    # init is refused by mixtral.create, as JAX's).
                    raise NotImplementedError("weight quantization of a MoE model (its router "
                                              "and expert stacks) is not implemented")
                if m is not None:
                    m.params = quantize_params(m.params, cfg.quantization,
                                               include_embed=cfg.quantize_embed,
                                               embed_bits=cfg.embed_bits)
        self._weights_source = "fake" if fake else self.target.weights_source
        if mesh is None and cfg.mesh_shape:
            mesh = make_mesh(**cfg.mesh_shape)
        elif mesh is not None and any(mesh.shape.get(axis, 1) != n
                                      for axis, n in cfg.mesh_shape.items()):
            raise ValueError(f"the mesh given ({mesh.shape}) differs from cfg.mesh_shape "
                             f"({cfg.mesh_shape})")
        self.mesh = mesh
        self._data = self.mesh.shape["data"] if self.mesh is not None else 1
        # Under the model axis the decode loops run their in-place step
        # eagerly (a graph cannot hold a gloo collective's host hop, and
        # capturing NCCL collectives is not done); under the data axis alone
        # each rank captures as in one process. Decided here, once.
        self.eager_loops = self.mesh is not None and self.mesh.shape["model"] > 1
        if self.mesh is not None:
            self._shard_models()
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
        # JAX's recorder, on under cfg.profile (JAX's SPECDX_PROFILE and
        # SPECDX_DETAILED_METRICS turn on the same one); profile_phases'
        # breakdowns are cached by (k, batch).
        self.profiler = StructuredProfiler(enabled=cfg.profile)
        self._phase_cache: Dict[tuple, Dict[str, Any]] = {}
        self.profiler.run_metadata = {
            "base_model": cfg.base_model, "draft_model": cfg.draft_model, "policy": cfg.policy,
            "controller": cfg.controller, "dtype": cfg.dtype, "backend": self.device.type}
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
        self._build_constraint()
        self._build_lora(list(lora_adapters or []))
        self._step, self._step_in_place = self._build_step(self._k), self._build_step(
            self._k, in_place=True)
        # Under per-request sampling the step computes the counts, the bias
        # row and the per-row filters at every row's values, greedy or not (a
        # captured graph cannot branch on them). Rows that are all greedy with
        # no penalty or bias get exactly the plain greedy step's tokens and
        # logprobs, so the host picks that step for them: `plain` (functional,
        # in place), or None without per-request sampling, and with Medusa
        # heads that sample (greedy=False): their drafts would differ.
        self._plain = ((self._build_step(self._k, plain=True),
                        self._build_step(self._k, in_place=True, plain=True))
                       if cfg.per_request_sampling
                       and (cfg.greedy or cfg.draft_mode != "medusa") else None)
        # The constrained step (functional, in place), or None without a
        # grammar: what a call or a batch with a constrained slot runs.
        self._fsm_steps = ((self._build_step(self._k, fsm=True),
                            self._build_step(self._k, in_place=True, fsm=True))
                           if self._constrain_tbl is not None else None)
        self._steps_by_k: Dict[int, Any] = {}  # the host adaptive controller's steps
        # The decode loops' graphs of this engine share one memory pool: they
        # never run at once.
        self.graph_pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                           else None)
        self._decode_states: Dict[Tuple[int, int], Tuple[DecodeState, DecodeLoop]] = {}
        # The constrained step's loops over the same decode states.
        self._fsm_loops: Dict[Tuple[int, int], DecodeLoop] = {}
        # The host adaptive controller's one-step loops, by (B, max_len, K).
        self.adaptive_loops: Dict[Tuple[int, int, int], DecodeLoop] = {}
        self.polls = 0  # host reads of the last decode
        if cfg.kv_ring:
            self._enable_kv_ring()
        self._prefill = make_prefill(self.target, self.draft, chunk=cfg.prefill_chunk,
                                     hidden=self.head_mode)

    def _shard_models(self) -> None:
        """The models as this rank holds them (JAX engine.py:201-212): under
        the model axis the target's share (parallel/sharding.py shard_model:
        loaded whole, then shard_params, as JAX's), and the draft's only
        with shard_draft and when its KV heads split over the axis, else
        the whole draft on every rank. Refuses what the port does not
        shard: a MoE model under any mesh; under the model axis the fake
        model and the profiler (its phase breakdown captures graphs)."""
        cfg, mesh = self.config, self.mesh
        if mesh.coords is None:
            raise ValueError(f"rank {mesh.rank} is outside the {mesh.shape} mesh")
        for m in (self.target, self.draft):
            if m is not None and getattr(m.config, "moe", False):
                raise NotImplementedError("a MoE model under a mesh is not sharded (the expert "
                                          "axis is not ported)")
        n = mesh.shape["model"]
        if n == 1:
            return
        if cfg.implementation == "fake":
            raise NotImplementedError("the fake model has no heads to shard over the model axis")
        if cfg.profile:
            raise NotImplementedError("the profiler under the model axis is not ported (its "
                                      "phase breakdown captures CUDA graphs, which cannot hold "
                                      "the axis's collectives)")
        self.target = shard_model(self.target, mesh)
        if self.draft is not None and cfg.shard_draft and self.draft.config.n_kv_heads % n == 0:
            self.draft = shard_model(self.draft, mesh)

    def make_loop(self, step) -> DecodeLoop:
        """A decode loop over an in-place step of this engine: in its graph
        pool, eager under the model axis (eager_loops)."""
        return make_decode_loop(step, pool=self.graph_pool, eager=self.eager_loops)

    def _build_constraint(self) -> None:
        """The grammar's token tables, compiled once on the host (JAX
        engine.py:320-404) and uploaded to the device, and the grammar keys
        the deployment serves with each one's initial state. None without
        ``constrain`` or ``tools`` (config.py checks the fields)."""
        cfg = self.config
        self._constrain_tbl = self.constrain_tables = None
        self._fsm_initial_map: Dict[str, int] = {}
        self._fsm_initial = fsm.UNCONSTRAINED
        self.constrain_compile_s = 0.0
        if cfg.constrain is None and not cfg.tools:
            return
        t0 = time.perf_counter()
        tool_initials = None
        if cfg.tools:
            # The union of the tools' call shapes, one initial a tool_choice
            # option; requests opt in, the default decode stays free.
            auto, tool_initials = build_tools_automaton(cfg.tools)
        elif cfg.constrain == "regex":
            auto = build_regex_automaton(cfg.constrain_regex)
        elif cfg.constrain == "json_schema":
            auto = build_schema_automaton(cfg.constrain_schema)
        else:
            auto = json_char_automaton()
        tb, tl = token_bytes_of(self.tokenizer, self.target.config.vocab_size)
        tt = compile_token_tables(auto, tb, tl, eos_id=self.eos_token_id
                                  if self.eos_token_id is not None else 0)
        self.constrain_compile_s = time.perf_counter() - t0
        # The tables on the host (views of the compiled arrays): the
        # batcher's walk of a resumed request's FSM.
        self.constrain_tables = fsm.device_tables(tt, "cpu")
        self._constrain_tbl = fsm.device_tables(tt, self.device)
        # Base char-state ids survive compile_token_tables, so the tool map's
        # initials are valid table rows.
        if tool_initials is not None:
            self._fsm_initial_map = dict(tool_initials)
        else:
            self._fsm_initial_map = ({cfg.constrain: tt.initial}
                                     if cfg.constrain in ("json_schema", "regex")
                                     else {"json": tt.initial, "json_object": tt.initial_objonly})
            self._fsm_initial = self._fsm_initial_map[cfg.constrain]

    def _build_lora(self, adapters: List[Adapter]) -> None:
        """Stack the given adapters and cfg.lora_paths' (JAX engine.py:407-431)
        into the target's LoRA pack, model dtype, on the device; lora_names
        maps each name to its index. The target gets a new params dict and
        layers dict holding the pack (the tensors are shared), so params
        handed in by a caller, or shared with another engine, stay as they
        were. Tree mode and the fake model refuse adapters."""
        cfg = self.config
        self.lora_names: Dict[str, int] = {}
        adapters = adapters + [load_peft_adapter(p, self.target.config)
                               for p in cfg.lora_paths or ()]
        if not adapters:
            return
        if self.tree is not None:
            raise ValueError("LoRA is not supported in tree mode")
        if self.eager_loops:
            raise NotImplementedError("LoRA under tensor parallelism (model > 1) is not sharded: "
                                      "each site's delta would need the rank's columns")
        if cfg.implementation == "fake":
            raise NotImplementedError("the fake model has no layers to adapt (LoRA)")
        pack, self.lora_names = build_pack(self.target.config, adapters,
                                           dtype=self.target.config.dtype, device=self.device)
        params = self.target.params
        self.target.params = dict(params, layers=dict(params["layers"], **pack))

    def lora_id(self, adapter: Optional[str]) -> int:
        """The pack index of an adapter name (None: -1, the base model);
        ValueError naming the loaded ones for any other name."""
        if adapter is None:
            return -1
        if adapter not in self.lora_names:
            raise ValueError(f"unknown LoRA adapter {adapter!r} (engine has "
                             f"{sorted(self.lora_names)})")
        return self.lora_names[adapter]

    def _resolve_fsm_initial(self, response_format: Optional[str]) -> int:
        """FSM start state for a grammar key ("json", "json_object",
        "json_schema", "regex", "tool_call", "tool_call:<name>"); None
        selects the deployment default (-1, unconstrained, without tables
        or under tools). A key the engine's grammar cannot serve raises
        ValueError with JAX's message: nothing decodes unconstrained in its
        place."""
        if response_format is None:
            return self._fsm_initial
        if self._constrain_tbl is None:
            raise ValueError("response_format requires the engine to be built with "
                             "EngineConfig(constrain=...) or EngineConfig(tools=...)")
        init = self._fsm_initial_map.get(response_format)
        if init is None:
            raise ValueError(f"this deployment's grammar cannot serve response_format "
                             f"{response_format!r} (available: "
                             f"{sorted(self._fsm_initial_map)})")
        return init

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

    def _build_step(self, k: int, in_place: bool = False, plain: bool = False,
                    fsm: bool = False):
        """The step at K = k (the baseline step when not speculative; the
        tree's step, which has no K, in tree mode); plain: the greedy step
        with no penalty and no per-request work (what per-request rows that
        are all greedy and unpenalized get); fsm: masked by the grammar's
        tables (config.py refuses a grammar in tree mode)."""
        cfg = self.config
        samp = dict(greedy=cfg.greedy, temperature=cfg.temperature, top_k=cfg.top_k,
                    top_p=cfg.top_p, min_p=cfg.min_p, eos_token_id=self.eos_token_id,
                    per_request_sampling=cfg.per_request_sampling,
                    logprobs_topk=cfg.logprobs_topk, in_place=in_place)
        if fsm:
            samp["constrain_tbl"] = self._constrain_tbl
        if plain:
            samp.update(greedy=True, per_request_sampling=False)
        if self.tree is not None:  # config.py refuses penalties in tree mode
            return make_tree_spec_step(self.target, self.tree, draft_params=self._draft_params,
                                       **samp)
        if not plain:
            samp.update(repetition_penalty=cfg.repetition_penalty,
                        presence_penalty=cfg.presence_penalty,
                        frequency_penalty=cfg.frequency_penalty)
        if not self.is_spec:
            return make_baseline_step(self.target, **samp)
        adaptive = isinstance(self.controller, AdaptiveDeviceKController)
        return make_spec_step(
            self.target, self.draft, k=k, policy_fn=self.policy_fn,
            policy_params=cfg.policy_params, draft_temperature_scale=cfg.draft_temperature_scale,
            draft_mode=cfg.draft_mode, ngram_cfg=cfg.ngram,
            adaptive_cfg=self.controller.adaptive_cfg() if adaptive else None,
            draft_params=self._draft_params, medusa_cfg=cfg.medusa, eagle_cfg=cfg.eagle, **samp)

    def _step_at(self, k: int, fsm: bool = False, plain: bool = False):
        """(functional, in place) steps at K = k, built once a K and variant:
        the grammar's (fsm), the plain greedy one (plain) or the engine's."""
        key = (k, "fsm") if fsm else (k, "plain") if plain else k
        if key not in self._steps_by_k:
            self._steps_by_k[key] = (self._build_step(k, fsm=fsm, plain=plain),
                                     self._build_step(k, in_place=True, fsm=fsm, plain=plain))
        return self._steps_by_k[key]

    def _enable_kv_ring(self) -> None:
        """Ring the contiguous KV cache of uniform sliding-window models: slot
        = position mod R with R = round_up(window + C + K + 2, 128), C the
        longest forward a prompt takes (the prefill chunk, or the serving
        batcher's admission chunk when longer), so a write (at position p,
        clobbering p - R) never reaches a row still inside a live query's
        window. Applied per model: a model without a window, or with
        Gemma-2's alternating one, keeps its plain cache, and so does one
        whose ring would not be shorter than max_seq_len."""
        cfg = self.config
        C = max(cfg.prefill_chunk, cfg.admit_chunk or 0)
        for model in (self.target, self.draft):
            if model is None:
                continue
            mc = model.config
            if mc.sliding_window is None or mc.alt_window:
                continue
            R = _round_up(mc.sliding_window + C + self._max_k + 2, 128)
            if R < cfg.max_seq_len:
                model.config = replace(mc, kv_ring_len=R)

    def generate(self, prompt: str, seed: Optional[int] = None,
                 response_format: Optional[str] = None,
                 adapter: Optional[str] = None,
                 max_new_tokens: Optional[int] = None) -> Dict[str, Any]:
        return self.generate_batch([prompt], seed=seed, response_format=response_format,
                                   adapter=adapter, max_new_tokens=max_new_tokens)[0]

    def encode(self, prompt: str, max_new: int, max_seq_len: int) -> List[int]:
        """Prompt ids, cut to leave room for max_new tokens and the step's
        K+2 scratch rows in max_seq_len, each clamped into the vocabulary
        (a trust-boundary clamp, always on: an out-of-vocab id would index
        past the embedding table)."""
        vocab = self.target.config.vocab_size
        ids = self.tokenizer.encode(prompt)[: max_seq_len - max_new - self._max_k - 2]
        return [min(max(t, 0), vocab - 1) for t in ids]

    def generate_batch(self, prompts: List[str], seed: Optional[int] = None,
                       response_format: Optional[str] = None,
                       adapter: Optional[str] = None,
                       max_new_tokens: Optional[int] = None) -> List[Dict[str, Any]]:
        """One result dict per prompt. seed: the key of the call's sampling
        (the config's seed when None); response_format: the grammar key of
        the whole batch (None: the deployment's default; _resolve_fsm_initial
        raises for a key it cannot serve); adapter: the LoRA adapter of the
        whole batch (None: the base model; lora_id raises for an unknown
        name); max_new_tokens: the call's budget (None: the config's), as
        JAX's generate_batch takes it. Under the data axis of a mesh each
        data rank decodes its block of the prompts (their number must split
        over the axis) and every rank returns every prompt's result."""
        with torch.inference_mode():
            local = prompts if self._data == 1 else prompts[self.mesh.data_slice(len(prompts))]
            results = self._build_results(*self._decode(local, seed, response_format,
                                                        adapter, max_new_tokens))
            if self._data > 1:
                results = self.mesh.gather_data(results)
        if self.profiler.enabled and self.profiler.phase_ms is None:
            # The phase breakdown once an engine (JAX engine.py:1139-1151,
            # whose SPECDX_PROFILE_PHASES is on by default): a failure is
            # recorded, not raised, as JAX's.
            try:
                self.profiler.phase_ms = self.profile_phases()
            except Exception as err:  # noqa: BLE001 - JAX's rule: never fail a generation
                self.profiler.phase_ms = {"error": str(err)}
        return results

    @torch.inference_mode()
    def decode(self, prompts: List[str], seed: Optional[int] = None,
               response_format: Optional[str] = None, adapter: Optional[str] = None
               ) -> Tuple[DecodeState, np.ndarray, float, float]:
        """Prefill the prompts and decode them to the end. Returns the final
        state (the caller's own: a later call does not change it), the prompt
        lengths, and the decode and total wall seconds."""
        state, plens, decode_s, total_s = self._decode(prompts, seed, response_format, adapter)
        if not self.flags.sync_steps:  # the engine's own decode state: a copy
            state = copy.deepcopy(state)
        return state, plens, decode_s, total_s

    def _decode(self, prompts: List[str], seed: Optional[int],
                response_format: Optional[str] = None, adapter: Optional[str] = None,
                max_new_tokens: Optional[int] = None
                ) -> Tuple[DecodeState, np.ndarray, float, float]:
        max_new = self.config.max_new_tokens if max_new_tokens is None else max_new_tokens
        seed = self.config.seed if seed is None else seed
        fsm_init = self._resolve_fsm_initial(response_format)
        lora_id = self.lora_id(adapter)
        constrained = fsm_init != fsm.UNCONSTRAINED
        block, plens, max_len = self._prompt_block(prompts, max_new)
        dev = self.device
        t_start = time.perf_counter()
        prompt = torch.from_numpy(block).to(dev), torch.from_numpy(plens).to(dev)
        if self.flags.sync_steps:
            state = self._prefill(self._init_state(len(plens), max_len, seed, fsm_init, lora_id,
                                                   max_new), *prompt)
        else:
            state, loop = self._decode_state(len(plens), max_len, seed, fsm_init, lora_id,
                                             max_new)
            assign(state, self._prefill(state, *prompt))
        self._sync()
        t_decode = time.perf_counter()
        self.profiler.record_prefill((t_decode - t_start) * 1e3)
        # Each active step commits >= 1 token, so max_new + 1 steps always
        # finish.
        if self.host_adaptive or self.profiler.enabled:
            state = self._run_observed(state, max_new, constrained)
        elif self.flags.sync_steps:
            # One host poll per step: active.any().
            self.polls = 0
            for _ in range(max_new + 1):
                self.polls += 1
                if not bool(state.active.any()):
                    break
                state = self._decode_steps(constrained)[0](state)
        elif constrained:
            self._run_loop(loop, state, plens, max_new, cap=FSM_CHUNK)
        else:
            self._run_loop(loop, state, plens, max_new)
        self._sync()
        decode_s = time.perf_counter() - t_decode
        total_s = time.perf_counter() - t_start
        return state, plens, decode_s, total_s

    def _prompt_block(self, prompts: List[str], max_new: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The right-padded prompt block [B, P], the prompt lengths and the
        buffer length: P a multiple of 32 (and of prefill_chunk when the
        prompt is longer than a chunk), the buffer P + max_new (the config's
        budget when None) + K + 2 rounded up to 128."""
        cfg = self.config
        max_new = cfg.max_new_tokens if max_new is None else max_new
        enc = [self.encode(p, max_new, cfg.max_seq_len) for p in prompts]
        plens = np.array([len(e) for e in enc], np.int32)
        P = _round_up(max(int(plens.max()), 1), 32)
        if cfg.prefill_chunk and P > cfg.prefill_chunk:
            P = _round_up(P, cfg.prefill_chunk)  # the chunks tile the prompt block
        block = np.zeros((len(enc), P), np.int32)
        for i, e in enumerate(enc):
            block[i, : len(e)] = e
        return block, plens, _round_up(P + max_new + self._max_k + 2, 128)

    def sampling_defaults(self) -> Dict[str, float]:
        """Each slot's sampling values with no request's own (JAX's
        _default_sampling and penalties): temperature 0 when greedy (a row
        at temperature <= 0 is greedy), the config's filters and
        penalties."""
        cfg = self.config
        return dict(temperature=0.0 if cfg.greedy else cfg.temperature, top_k=cfg.top_k,
                    top_p=cfg.top_p, min_p=cfg.min_p, rep_penalty=cfg.repetition_penalty,
                    presence_penalty=cfg.presence_penalty, freq_penalty=cfg.frequency_penalty)

    def _decode_steps(self, constrained: bool = False):
        """(functional, in place) steps of generate: the constrained pair for
        a constrained call, else the plain pair when per-request sampling's
        rows, all at the config's values, are greedy and unpenalized
        (plain_rows)."""
        if constrained:
            return self._fsm_steps
        if self._plain is not None and plain_rows(self.sampling_defaults()):
            return self._plain
        return self._step, self._step_in_place

    def _init_state(self, B: int, max_len: int, seed: Optional[int] = None,
                    fsm_init: int = fsm.UNCONSTRAINED, lora_id: int = -1,
                    max_new: Optional[int] = None) -> DecodeState:
        cfg = self.config
        return init_state(self.target, self.draft, B, max_len, self.device,
                          max_new_tokens=cfg.max_new_tokens if max_new is None else max_new,
                          paged=cfg.kv_layout == "paged",
                          page_size=cfg.kv_page_size, kv_dtype=self.kv_dtype,
                          seed=cfg.seed if seed is None else seed, init_k=self.controller.k,
                          defaults=self.sampling_defaults(), logprobs_topk=cfg.logprobs_topk,
                          fsm_init=fsm_init, lora_id=lora_id,
                          row0=self.mesh.coords["data"] * B if self._data > 1 else 0)

    def _decode_state(self, B: int, max_len: int, seed: Optional[int] = None,
                      fsm_init: int = fsm.UNCONSTRAINED, lora_id: int = -1,
                      max_new: Optional[int] = None) -> Tuple[DecodeState, DecodeLoop]:
        """The decode state of this shape, reset to init_state's values with
        every lane's FSM at fsm_init and adapter lora_id, and the loop to
        replay over it: the unconstrained step's, or with fsm_init set the
        constrained step's (each captured at its first call, both over the
        same state)."""
        seed = self.config.seed if seed is None else seed
        max_new = self.config.max_new_tokens if max_new is None else max_new
        held = self._decode_states.get((B, max_len))
        if held is None:
            held = (self._init_state(B, max_len, seed, fsm_init, lora_id, max_new),
                    self.make_loop(self._decode_steps()[1]))
            self._decode_states[(B, max_len)] = held
        else:
            reset_state(held[0], max_new, seed, self.controller.k,
                        self.sampling_defaults(), fsm_init, lora_id)
        if fsm_init == fsm.UNCONSTRAINED:
            return held
        loop = self._fsm_loops.get((B, max_len))
        if loop is None:
            loop = self._fsm_loops[(B, max_len)] = self.make_loop(self._fsm_steps[1])
        return held[0], loop

    def _run_loop(self, loop: DecodeLoop, state: DecodeState, plens: np.ndarray,
                  max_new: int, cap: Optional[int] = None) -> None:
        """Chunks of loop replays, one host read of (steps, active, lengths)
        after each, until no lane is active or max_new + 1 steps ran (JAX's
        max_steps). A chunk is ceil(largest remaining budget / (K + 1)) steps
        (a tree's depth + 1): a step commits at most that many tokens, so no
        step runs past the end unless a lane hits EOS or the buffer end, or
        commits fewer. cap: at most that many steps a chunk (a constrained
        call, whose grammar often ends the output in EOS long before the
        budget: the replays after it would change nothing)."""
        per_step = (self.tree.depth + 1 if self.tree is not None
                    else self._k + 1 if self.is_spec else 1)
        B = len(plens)
        steps, active, lengths = 0, plens > 0, plens.astype(np.int64)
        self.polls = 0
        while active.any() and steps < max_new + 1:
            remaining = int((plens + max_new - lengths)[active].max())
            n = min(max(-(-remaining // per_step), 1), max_new + 1 - steps)
            loop(state, n if cap is None else min(n, cap))
            polled = torch.cat([state.steps[None], state.active.to(torch.int32),
                                state.lengths]).cpu().numpy()
            self.polls += 1
            steps, active, lengths = int(polled[0]), polled[1:B + 1].astype(bool), polled[B + 1:]

    def _run_observed(self, state: DecodeState, max_new: int,
                      constrained: bool = False) -> DecodeState:
        """JAX's observed loop, under the host adaptive controller or the
        profiler: before each step the controller picks K (the engine's own
        step otherwise); after it the sums (proposed, accepted, any active)
        of the step before are read (one step of lag, so the read overlaps
        the step on the card) and fed to the controller, and the loop ends
        when they show no active lane. So it runs one step after the last
        lane finished, which changes nothing (the state's ``steps`` does not
        count it; JAX's result counts it). Each step is the functional step
        at K under sync_steps, else one replay of the one-step loop of K over
        the engine's decode state (on the card a graph captured at K's first
        step, in the engine's pool; the constrained step's at K for a
        constrained call). Under the profiler each step is timed
        (StructuredProfiler.time_step: CUDA events on the card) and its
        accepted drafts recorded, read once after the loop."""
        ctrl = self.controller
        B, max_len = state.tokens.shape
        on_card = state.tokens.is_cuda
        prof = self.profiler
        pending = None
        prev_prop = prev_acc = 0
        marks, step_sums = [], []  # under the profiler: each step's time and sums
        self.polls = 0
        for step_i in range(max_new + 1):
            if self.host_adaptive:
                k = ctrl.get_k(step_i)
                steps = self._step_at(k, fsm=True) if constrained else self._step_at(k)
            else:
                k, steps = self._k, self._decode_steps(constrained)
            with (stopwatch(state.tokens.device, marks) if prof.enabled
                  else contextlib.nullcontext()):
                if self.flags.sync_steps:
                    state = steps[0](state)
                else:
                    key = (B, max_len, k) + (("fsm",) if constrained else ())
                    loop = self.adaptive_loops.get(key)
                    if loop is None:
                        loop = self.make_loop(steps[1])
                        self.adaptive_loops[key] = loop
                    loop(state, 1)
            sums = torch.stack([state.proposed.sum(), state.accepted.sum(),
                                state.active.any().to(state.proposed.dtype)])
            if prof.enabled:
                step_sums.append(sums)
            if pending is not None:
                if on_card:
                    pending[1].synchronize()
                prop, acc, act = (int(x) for x in pending[0])
                self.polls += 1
                ctrl.update(prop - prev_prop, acc - prev_acc)
                prev_prop, prev_acc = prop, acc
                if not act:
                    break
            if on_card:
                host = torch.empty(3, dtype=sums.dtype, pin_memory=True)
                host.copy_(sums, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                pending = (host, done)
            else:
                pending = (sums, None)
        if prof.enabled:
            accepted = [0] + torch.stack(step_sums)[:, 1].cpu().tolist()
            for i, ms in enumerate(read_ms(marks)):
                prof.record_step(ms, accepted=accepted[i + 1] - accepted[i])
        return state

    @torch.inference_mode()
    def profile_phases(self, batch: int = 1) -> Dict[str, Any]:
        """The decode step split into phases (JAX Engine.profile_phases),
        each timed as the slope of a dependent chain (slope_chain_ms: on the
        card replays of a CUDA graph captured over one link, as the decode
        loop replays the step):

          draft_ms   = K x one single-token draft-model forward
          verify_ms  = one target forward over K + 1 rows
          step_ms    = the engine's whole step (its in-place step at K)
          commit_sample_ms = step_ms - draft_ms - verify_ms

        K is the engine's largest (``_max_k``; 0 without speculation). The
        modes without a draft model (ngram, medusa, eagle, tree) have
        draft_ms 0: their drafting lands in verify or commit. Caches are
        contiguous of the engine's KV type, B = batch lanes at position 8
        of max_seq_len. Cached per (k, batch)."""
        k = self._max_k if self.is_spec else 0
        key = (k, batch)
        if key in self._phase_cache:
            return self._phase_cache[key]
        B, T, dev = batch, self.config.max_seq_len, self.device
        tgt = self.target

        def i32(*shape, fill):
            return torch.full(shape, fill, dtype=torch.int32, device=dev)

        draft1 = 0.0
        if self.draft is not None and k > 0:
            d = self.draft

            def dfwd(params, carry):
                tok, cache = carry
                logits = d.forward(tok, i32(B, 1, fill=8), cache, i32(B, fill=7))[0]
                tok.copy_(logits[:, -1:].argmax(-1))

            draft1 = slope_chain_ms(dfwd, None, (i32(B, 1, fill=1),
                                                 d.init_cache(B, T, dev, dtype=self.kv_dtype)))
        R = k + 1  # verify rows a lane
        rows = (torch.arange(R, dtype=torch.int32, device=dev) + 8)[None].repeat(B, 1)

        def vfwd(params, carry):
            tok, cache = carry
            logits = tgt.forward(tok, rows, cache, i32(B, fill=7))[0]
            tok.copy_(torch.cat([tok[:, 1:], logits[:, -1:].argmax(-1).to(tok.dtype)], 1))

        verify = slope_chain_ms(vfwd, None, (i32(B, R, fill=1),
                                             tgt.init_cache(B, T, dev, dtype=self.kv_dtype)))
        step_fn = self._build_step(max(k, 1) if self.is_spec else 1, in_place=True)
        state = init_state(tgt, self.draft, B, T, dev, max_new_tokens=10_000,
                           kv_dtype=self.kv_dtype, seed=self.config.seed,
                           init_k=self.controller.k, defaults=self.sampling_defaults(),
                           logprobs_topk=self.config.logprobs_topk)
        state.lengths.fill_(8)
        state.prompt_lens.fill_(8)
        state.active.fill_(True)
        state.tokens[:, :8] = 1
        step = slope_chain_ms(lambda params, st: step_fn(st), None, state)
        out = {
            "k": k,
            "batch": B,
            "draft_forwards": k if self.draft is not None else 0,
            "draft_ms": round(k * draft1, 4),
            "draft_ms_per_forward": round(draft1, 4),
            "verify_ms": round(verify, 4),
            "commit_sample_ms": round(step - k * draft1 - verify, 4),
            "step_ms": round(step, 4),
        }
        self._phase_cache[key] = out
        return out

    @torch.inference_mode()
    def embed(self, texts: List[str], pooling: str = "mean",
              normalize: bool = True) -> Tuple[np.ndarray, int]:
        """Sentence embeddings from the target's final (post-norm) hidden
        states (JAX Engine.embed, engine.py:643-702; OpenAI /v1/embeddings):
        one eager prefill-shaped forward of the target over a scratch
        contiguous cache that is freed after the call, outside any graph and
        without the head; the base model (no adapter), as JAX's. Each text
        is cut to max_seq_len tokens (ids clamped into the vocabulary, as
        ``encode`` clamps them) and right-padded to a multiple of 32.
        pooling: "mean" (over each text's tokens, in f32) or "last" (its
        last token's row); normalize: each row divided by max(its L2 norm,
        1e-9). Returns (f32 numpy [B, D], the prompt tokens)."""
        if pooling not in ("mean", "last"):
            raise ValueError(f"pooling must be 'mean' or 'last', got {pooling!r}")
        cfg = self.config
        vocab = self.target.config.vocab_size
        enc = [[min(max(t, 0), vocab - 1) for t in self.tokenizer.encode(text)[: cfg.max_seq_len]]
               for text in texts]
        plens = np.array([max(len(e), 1) for e in enc], np.int32)
        P = _round_up(int(plens.max()), 32)
        ring = self.target.config.kv_ring_len
        if ring is not None and P > ring:
            # One forward over more rows than the ring holds would overwrite
            # rows its own queries still need.
            raise ValueError(f"embed: {P} tokens do not fit the target's KV ring of {ring}")
        block = np.zeros((len(enc), P), np.int32)
        for i, e in enumerate(enc):
            block[i, : len(e)] = e
        B, dev = len(enc), self.device
        tokens = torch.from_numpy(block).to(dev)
        lens = torch.from_numpy(plens).to(dev)
        positions = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
        cache = self.target.init_cache(B, P, dev)
        _, _, hidden = self.target.forward(tokens, positions.contiguous(), cache,
                                           torch.zeros((B,), dtype=torch.int32, device=dev),
                                           return_hidden=True, logits=False)
        del cache
        hidden = hidden.float()
        if pooling == "last":
            emb = hidden[torch.arange(B, device=dev), (lens - 1).clamp(0, P - 1).long()]
        else:
            m = (torch.arange(P, device=dev)[None] < lens[:, None]).float()
            emb = (hidden * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]
        if normalize:
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp_min(1e-9)
        return emb.cpu().numpy(), int(plens.sum())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        tops = ((state.top_ids.cpu().numpy(), state.top_lps.cpu().numpy())
                if cfg.logprobs_topk else None)
        mem = device_memory_stats(self.device).as_dict()
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
                "top_logprobs": (top_logprobs(tops, b, plens[b], lengths[b])
                                 if tops is not None else None),
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
