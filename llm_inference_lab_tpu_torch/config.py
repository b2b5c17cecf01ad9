"""Engine configuration: the fields of llm_inference_lab_tpu/config.py
EngineConfig that the ported slice reads.

The slice is vanilla drafting from a draft model, ngram drafting from the
token buffer, Medusa-lite and EAGLE-lite drafting from the target's hidden
state and tree speculation (``draft_mode``), the five acceptance policies,
the three K controllers, greedy decoding or engine-level sampling
(temperature, min_p, top_k, top_p), HF repetition and OpenAI presence and
frequency penalties (static, engine-wide), per-request sampling
(``per_request_sampling``: each slot's filters, penalties, ``logit_bias``
and seed in the decode state, what the OpenAI server sets), top-N logprobs
(``logprobs_topk``), the real models or the fake test model
(``implementation``), weight-only int4/int8 and a bf16 or int8 KV cache
(per-row scales), contiguous or paged, single-shot or chunked prefill, and
the rolling-buffer cache (``kv_ring``) of uniform sliding-window models; in
serving, incremental (chunked) admission (``admit_chunk``), lazy page growth
with preemption (``kv_lazy_pages``, on by default as in JAX) and prefix
caching (``prefix_caching``), grammar-constrained decoding
(``constrain`` with ``constrain_schema`` or ``constrain_regex``, or
``tools``: the grammar's token tables, built once by the engine, masking
every sampling site), the int8 or int4 embedding and tied head
(``quantize_embed`` with ``embed_bits`` 8 or 4), LoRA adapters from
local PEFT directories (``lora_paths``; ``Engine(lora_adapters=...)`` takes
them built), and the data and model axes of a mesh (``mesh_shape``,
``shard_draft``). ``profile`` turns on the engine's StructuredProfiler
(metrics/profiler.py): the one switch for JAX's SPECDX_PROFILE and
SPECDX_DETAILED_METRICS. A field of the JAX config with a single ported value
has no field here until a later slice ports a second value for it. Fields
are named
and defaulted as in JAX, except ``implementation``, "hf" here ("fake" in
JAX): the port's entry points build the named model unless a caller asks
for the fake one.

``EnvFlags`` is the port's copy of the JAX package's runtime flags with the
fields it reads, and JAX's two serving switches that its batcher reads
inline from the environment (``SPECDX_OVERLAP_ADMIT``,
``SPECDX_FUSED_ADMIT``). It has no ``from_env``: the port reads no
environment variable, and a caller passes ``Engine(config,
flags=EnvFlags(...))`` or ``run_k_sweep(flags=EnvFlags(...))``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

DRAFT_MODES = ("vanilla", "ngram", "medusa", "eagle", "tree")
# The modes that draft from the target's hidden-state carry: no draft model.
HEAD_MODES = ("medusa", "eagle", "tree")
MAX_TREE_S = 32  # the verify chunk of a tree on the card: num_nodes + 1 rows at most
CONTROLLERS = ("fixed", "adaptive", "adaptive-device")
CONSTRAINTS = ("json", "json_object", "json_schema", "regex")
MESH_AXES = ("data", "model", "seq", "stage", "expert")


@dataclass(frozen=True)
class EnvFlags:
    # Decode on the host: one step at a time, one ``active.any()`` poll after
    # each (JAX's observed loop). False (the default): the decode loop of
    # core/specstep.py, CUDA-graph replays of the step on the card.
    sync_steps: bool = False
    # The batcher's admission experiments, off as in JAX: admit into the
    # slots free at the live snapshot right after a chunk is enqueued
    # (overlap_admit), and enqueue the wave planned before a chunk straight
    # ahead of its replays (fused_admit).
    overlap_admit: bool = False
    fused_admit: bool = False
    # The K sweep's (bench/k_sweep.py): synthetic results without touching
    # the device (JAX's SPECDX_DRY_RUN), and its batch size (JAX's
    # SPECDX_BATCH_SIZE; 0: the whole prompt suite in one batch).
    dry_run: bool = False
    batch_size: int = 0


@dataclass
class EngineConfig:
    base_model: str = "llama-3.2-3b"
    draft_model: Optional[str] = "llama-3.2-1b"
    implementation: str = "hf"  # "hf" (the named model) | "fake" (models/fake.py)
    # "vanilla" (a draft model) | "ngram" (prompt lookup in the token buffer)
    # | "medusa" (K heads over the target's hidden state) | "eagle" (the
    # hidden state extrapolated through the target's head) | "tree" (a tree
    # of head candidates verified in one forward): every mode but vanilla
    # has no draft model and no draft cache.
    draft_mode: str = "vanilla"
    max_draft: int = 4  # K
    policy: str = "longest_prefix"  # | conf_threshold | topk_agree | typical | rejection
    policy_params: dict = field(default_factory=dict)
    controller: str = "fixed"  # | adaptive | adaptive-device
    controller_params: dict = field(default_factory=dict)
    # Sampling, engine-wide. greedy=True (or temperature <= 0) takes the
    # argmax; otherwise temperature -> min_p -> top_k -> top_p, sampled from
    # the decode state's key. Drafts sample at temperature /
    # draft_temperature_scale.
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    greedy: bool = True
    draft_temperature_scale: float = 1.5
    # Penalties (off at these values): HF repetition (a seen token's logit
    # divided by r when positive, multiplied when negative) and OpenAI
    # presence and frequency (minus p for a seen token, minus f per
    # occurrence), over the committed text (prompt and generation), before
    # temperature and the filters. A spec step penalizes verify row i with
    # the counts of the text and drafts d_1..d_i, so greedy spec ids equal a
    # penalized baseline's. Not in tree mode.
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Per-request sampling: temperature, top_k, top_p, min_p, the penalties,
    # logit_bias and the seed live in the decode state, one value a slot
    # (the batcher writes a request's at admission; a row at temperature
    # <= 0 decodes greedily), and each row draws from its slot's key folded
    # with its committed length. Off: the scalars above are the step's. Not
    # with policy "rejection" (its distributions are the engine's).
    per_request_sampling: bool = False
    # Top-N alternatives (ids and log-probs) of every generated token,
    # captured from the verify logits at commit; 0 = off (no buffers).
    logprobs_topk: int = 0
    max_seq_len: int = 1024
    max_new_tokens: int = 64
    dtype: str = "bfloat16"
    quantization: Optional[str] = None  # None | "int8" | "int4"
    quantize_embed: bool = False
    embed_bits: int = 8  # 8 (EmbedQuant) or 4 (EmbedQuant4: the head through kernel A, f32 out)
    quantized_init: bool = False
    seed: int = 0
    eos_token_id: Optional[int] = None
    # The engine's StructuredProfiler: prefill and per-step ms and the
    # acceptance histogram of generate, and profile_phases' breakdown.
    profile: bool = False
    # KV cache layout: "contiguous" (one [max_seq] lane per slot) or "paged"
    # (a page pool and per-sequence page tables, models/paged.py).
    kv_layout: str = "contiguous"
    kv_page_size: int = 64
    kv_pages: Optional[int] = None  # pool size; None = slots * pages per sequence + 1
    # KV cache element type: None (the model dtype) or "int8" (symmetric
    # per-row scales, quantized as each row is written).
    kv_quantization: Optional[str] = None  # None | "int8"
    # Chunked prefill: prompts longer than this prefill in forwards of this
    # many tokens, each attending to the rows the earlier chunks wrote
    # (None = one forward over the whole prompt).
    prefill_chunk: Optional[int] = None
    # Rolling-buffer KV for uniform sliding-window models (Mistral): the
    # contiguous cache becomes a ring of window + prefill_chunk + K + 2
    # slots, rounded up to 128 (slot = position mod ring), when that is
    # shorter than max_seq_len. Needs the contiguous layout and
    # prefill_chunk, a multiple of 32: a single-shot prefill longer than the
    # ring would overwrite rows its own queries still need.
    kv_ring: bool = False
    # Serving (core/batching.py). Interleaved (chunked) admission: a prompt
    # longer than admit_chunk prefills into a detached scratch this many
    # tokens after each decode chunk; the splice is the only write to the
    # decode state. A multiple of the KV bucket (page size, or 32
    # contiguous: the batcher checks); None (or 0) = one-shot admission.
    # Not applied under prefix caching. A ring engine sizes its ring from
    # max(prefill_chunk, admit_chunk) and serves only with it.
    admit_chunk: Optional[int] = None
    # Lazy pages (paged layout): admission reserves the prompt and a growth
    # margin; each poll grows a slot's pages ahead of its length and, with
    # the pool dry, preempts the youngest slot (pages freed, request requeued
    # and resumed by recomputing prompt + generated tokens). False: the
    # worst case (prompt + budget + K + 2) reserved at admission.
    kv_lazy_pages: bool = True
    # Automatic prefix caching (paged layout only: the batcher checks): full
    # prompt pages are shared between requests with the same prefix
    # (models/paged.py PrefixPageCache) and admission forwards the suffix.
    prefix_caching: bool = False
    # Grammar-constrained decoding (constrain/): None disables; "json" (any
    # top-level value), "json_object" (OpenAI response_format), "json_schema"
    # (structured outputs: needs constrain_schema) or "regex" (guided regex,
    # an anchored full match: needs constrain_regex). The engine compiles the
    # grammar's token tables once and masks every sampling site on the
    # device; the value is Engine.generate's default and fixes which grammar
    # the deployment serves (requests opt in by response_format).
    constrain: Optional[str] = None
    constrain_schema: Optional[dict] = None
    constrain_regex: Optional[str] = None
    # Tool calling (constrain/tools.py): the OpenAI `tools` list compiled
    # into a tool-call grammar ({"name": ..., "arguments": ...} under each
    # tool's parameters schema). Requests opt in by tool_choice ("required"
    # or a named function; "auto" is unconstrained and parsed on the host).
    # Not with `constrain` (one grammar table a deployment).
    tools: Optional[list] = None
    # Multi-LoRA serving (models/lora.py): local HF PEFT adapter directories
    # (adapter_config.json + adapter_model.safetensors; nothing is
    # downloaded), each loaded under its directory's basename and stacked
    # into one pack; a request picks one by name (generate(adapter=...),
    # submit(lora=...), the server's `model` field). Not in tree mode.
    lora_paths: Optional[list] = None
    ngram: dict = field(default_factory=lambda: {"n": 2})
    # Medusa heads: K projections [D, D] ahead of the target's head ("tie" or
    # "copy": identity; "random": identity plus N(0, 0.02^2) noise), sampled
    # at this temperature and top_p unless greedy. num_heads is JAX's field:
    # the engine sizes the heads by the largest K (or the tree's depth).
    medusa: dict = field(default_factory=lambda: {"num_heads": 2, "head_init": "tie",
                                                  "temperature": 0.7, "top_p": 0.9})
    # EAGLE-lite: h' = h + alpha (h - h_prev), K times, each through the head.
    eagle: dict = field(default_factory=lambda: {"alpha": 0.7, "max_draft": 2})
    # Tree speculation: children per node at each depth (core/treespec.py).
    tree: dict = field(default_factory=lambda: {"branching": [3, 2]})
    # Parallelism (JAX config.py:206-209): the mesh's axes, e.g. {"data": 2,
    # "model": 2} (parallel/mesh.py make_mesh over the initialised world,
    # when Engine is given no mesh; the seq, stage and expert axes are not
    # ported and raise), and whether the draft model shards on the model
    # axis too (only when its KV heads split; else it runs whole on every
    # rank).
    mesh_shape: dict = field(default_factory=dict)
    shard_draft: bool = False

    def override(self, **kwargs: Any) -> "EngineConfig":
        """A copy with the non-None values applied (JAX's config.py:236-241,
        the CLI layer)."""
        return dataclasses.replace(self, **{k: v for k, v in kwargs.items() if v is not None})

    def validate(self) -> None:
        """Reject settings outside the ported slice instead of ignoring them."""
        if self.implementation not in ("hf", "fake"):
            raise ValueError(f"unknown implementation {self.implementation!r}")
        if self.draft_mode not in DRAFT_MODES:
            raise ValueError(f"unknown draft_mode {self.draft_mode!r}")
        if self.draft_mode == "ngram" and int(self.ngram.get("n", 2)) < 1:
            raise ValueError(f"ngram n must be at least 1, got {self.ngram}")
        from llm_inference_lab_tpu_torch.core.policies import POLICIES

        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; known: {sorted(POLICIES)}")
        if self.controller not in CONTROLLERS:
            raise ValueError(f"unknown controller {self.controller!r}; known: "
                             f"{list(CONTROLLERS)}")
        if self.max_draft < 1:
            raise ValueError(f"max_draft must be at least 1, got {self.max_draft}")
        if self.implementation == "fake" and (
                self.quantization or self.quantize_embed or self.kv_quantization
                or self.kv_layout != "contiguous" or self.kv_ring):
            raise NotImplementedError("the fake model takes a contiguous bf16 cache and no "
                                      "quantization")
        if self.embed_bits not in (4, 8):
            raise ValueError(f"embed_bits must be 4 or 8, got {self.embed_bits}")
        for path in self.lora_paths or ():
            if not os.path.isfile(os.path.join(path, "adapter_config.json")):
                raise ValueError(f"lora_paths: {path!r} is not a local PEFT adapter directory "
                                 "(no adapter_config.json; nothing is downloaded)")
        if self.quantization not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
        if self.kv_quantization not in (None, "int8"):
            raise ValueError(f"unknown kv_quantization {self.kv_quantization!r}")
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_layout == "paged" and (self.kv_page_size <= 0 or 128 % self.kv_page_size):
            raise ValueError("kv_page_size must divide 128 (buffer bucketing)")
        if self.prefill_chunk is not None and self.prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive, got {self.prefill_chunk}")
        if self.kv_ring:
            if self.kv_layout != "contiguous":
                raise ValueError("kv_ring requires kv_layout='contiguous'")
            if not self.prefill_chunk:
                raise ValueError("kv_ring requires prefill_chunk (a single-shot prefill longer "
                                 "than the ring would overwrite rows its own queries still "
                                 "need); set e.g. prefill_chunk=512")
            if self.prefill_chunk % 32:
                raise ValueError("kv_ring needs prefill_chunk to be a multiple of 32 (the prompt "
                                 "bucket) so no forward ever exceeds the chunk")
        if self.admit_chunk is not None and self.admit_chunk < 0:
            raise ValueError(f"admit_chunk must not be negative, got {self.admit_chunk}")
        if self.logprobs_topk < 0:
            raise ValueError(f"logprobs_topk must not be negative, got {self.logprobs_topk}")
        unknown_axes = sorted(set(self.mesh_shape) - set(MESH_AXES))
        if unknown_axes or any(int(v) < 1 for v in self.mesh_shape.values()):
            raise ValueError(f"mesh_shape takes positive sizes of the axes {list(MESH_AXES)}, "
                             f"got {self.mesh_shape}")
        if self.per_request_sampling and self.policy == "rejection":
            raise NotImplementedError("per-request sampling parameters are not supported with "
                                      "the rejection policy (its distributions are the "
                                      "engine's)")
        self._validate_constrain()
        if self.draft_mode == "tree":
            self._validate_tree()

    def _validate_constrain(self) -> None:
        """JAX's engine checks of the grammar fields (core/engine.py:324-378),
        in its order and with its messages."""
        if self.tools and self.constrain is not None:
            raise ValueError("tools and constrain are mutually exclusive (one grammar table per "
                             "deployment)")
        if self.constrain is None and not self.tools:
            return
        if self.constrain is not None and self.constrain not in CONSTRAINTS:
            raise ValueError(f"constrain must be 'json', 'json_object', 'json_schema', or "
                             f"'regex', got {self.constrain!r}")
        if self.draft_mode == "tree":
            raise ValueError("constrained decoding is not supported in tree mode")
        if self.constrain == "regex" and not self.constrain_regex:
            raise ValueError("constrain='regex' requires constrain_regex")
        if self.constrain == "json_schema" and not self.constrain_schema:
            raise ValueError("constrain='json_schema' requires constrain_schema")

    @property
    def penalized(self) -> bool:
        """Static penalties set (off at 1.0, 0.0, 0.0)."""
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    def _validate_tree(self) -> None:
        """What JAX's engine refuses in tree mode (the ring: core/engine.py
        _enable_kv_ring; penalties: _build_step), and what the port's tree
        step lacks: the rejection policy's draft distributions and the
        adaptive controllers (JAX's tree step walks greedily, with no K). A
        binding window with the tree mask raises in the forward, as in
        JAX."""
        branching = list(self.tree.get("branching", [3, 2]))
        if not branching or any(int(b) < 1 for b in branching):
            raise ValueError(f"tree branching must be positive integers, got {branching}")
        if self.kv_ring:
            raise ValueError("kv_ring is not supported in tree mode")
        if self.penalized:
            raise ValueError("repetition/presence/frequency penalties are not supported in "
                             "tree mode")
        if self.policy != "longest_prefix":
            raise NotImplementedError(f"tree mode walks the tree greedily; policy "
                                      f"{self.policy!r} is not ported for it")
        if self.controller != "fixed":
            raise NotImplementedError(f"tree mode has no K; controller {self.controller!r} is "
                                      "not ported for it")


def load_config(path: Optional[str] = None, defaults: Optional[Dict[str, Any]] = None,
                **overrides: Any) -> EngineConfig:
    """An EngineConfig from defaults <- the config file at path <- overrides
    (None ones skipped), JAX's precedence (config.py:244-257). defaults:
    field values beneath the file's (the CLI's own defaults). A key the
    port's config does not have raises: it is not ported (JAX drops it)."""
    data: Dict[str, Any] = dict(defaults or {})
    if path:
        import yaml

        with open(path) as f:
            data.update(yaml.safe_load(f) or {})
    data.update({k: v for k, v in overrides.items() if v is not None})
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(f"config keys {unknown} are not fields of the port's EngineConfig")
    return EngineConfig(**data)

