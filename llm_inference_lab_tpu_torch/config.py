"""Engine configuration: the fields of llm_inference_lab_tpu/config.py
EngineConfig that the ported slice reads.

The slice is vanilla drafting from a draft model, ngram drafting from the
token buffer, Medusa-lite and EAGLE-lite drafting from the target's hidden
state and tree speculation (``draft_mode``), the five acceptance policies, the three K controllers,
greedy decoding or engine-level sampling (temperature, min_p, top_k,
top_p), the real models or the fake test model (``implementation``),
weight-only int4/int8 and a bf16 or int8 KV cache (per-row scales),
contiguous or paged, single-shot or chunked prefill, and the rolling-buffer
cache (``kv_ring``) of uniform sliding-window models. A field of the JAX
config with a single ported value has no field here until a later slice
ports a second value for it. So ``prefix_caching`` (off), ``admit_chunk``
(one-shot admission), ``kv_lazy_pages`` (eager page reservation,
``kv_lazy_pages=False`` in JAX), ``per_request_sampling`` (off), the
penalties (off) have no field yet. Fields are named and defaulted as in JAX, except
``implementation``, "hf" here ("fake" in JAX): the port's entry points build
the named model unless a caller asks for the fake one.

``EnvFlags`` is the port's copy of the JAX package's runtime flags with the
one field it reads. It has no ``from_env``: the port reads no environment
variable, and a caller passes ``Engine(config, flags=EnvFlags(...))``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

DRAFT_MODES = ("vanilla", "ngram", "medusa", "eagle", "tree")
# The modes that draft from the target's hidden-state carry: no draft model.
HEAD_MODES = ("medusa", "eagle", "tree")
MAX_TREE_S = 32  # the verify chunk of a tree on the card: num_nodes + 1 rows at most
CONTROLLERS = ("fixed", "adaptive", "adaptive-device")


@dataclass(frozen=True)
class EnvFlags:
    # Decode on the host: one step at a time, one ``active.any()`` poll after
    # each (JAX's observed loop). False (the default): the decode loop of
    # core/specstep.py, CUDA-graph replays of the step on the card.
    sync_steps: bool = False


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
    max_seq_len: int = 1024
    max_new_tokens: int = 64
    dtype: str = "bfloat16"
    quantization: Optional[str] = None  # None | "int8" | "int4"
    quantize_embed: bool = False
    embed_bits: int = 8  # 8 (EmbedQuant) or 4 (EmbedQuant4, not ported yet)
    quantized_init: bool = False
    seed: int = 0
    eos_token_id: Optional[int] = None
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
        if self.quantize_embed and self.embed_bits == 4:
            raise NotImplementedError("int4 embedding (EmbedQuant4) is not ported yet")
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
        if self.draft_mode == "tree":
            self._validate_tree()

    def _validate_tree(self) -> None:
        """What JAX's engine refuses in tree mode (the ring: core/engine.py
        _enable_kv_ring), and what the port's tree step lacks: the
        rejection policy's draft distributions and the adaptive controllers
        (JAX's tree step walks greedily, with no K). A binding window with
        the tree mask raises in the forward, as in JAX."""
        branching = list(self.tree.get("branching", [3, 2]))
        if not branching or any(int(b) < 1 for b in branching):
            raise ValueError(f"tree branching must be positive integers, got {branching}")
        if self.kv_ring:
            raise ValueError("kv_ring is not supported in tree mode")
        if self.policy != "longest_prefix":
            raise NotImplementedError(f"tree mode walks the tree greedily; policy "
                                      f"{self.policy!r} is not ported for it")
        if self.controller != "fixed":
            raise NotImplementedError(f"tree mode has no K; controller {self.controller!r} is "
                                      "not ported for it")
