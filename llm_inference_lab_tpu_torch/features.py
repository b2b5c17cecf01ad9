"""Feature-compatibility matrix (a copy of llm_inference_lab_tpu/features.py
with the port's raise sites).

The matrix covers the serving-facing config dimensions: every (draft mode x
KV layout x feature) cell either works through the ContinuousBatcher or
raises the documented error (tests/test_torch_features.py runs every cell).
``expected_error`` gives JAX's rules, each citing the port's raise site
(``RAISE_SITES``); ``port_refusals`` lists what the port refuses beyond
them, each with its raise site. Nothing else is refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Draft modes: baseline = no speculation, vanilla = draft-model chain,
# ngram = prompt-lookup, medusa/eagle = head-drafted chains, tree =
# head-drafted tree with ancestry-masked verify.
MODES = ("baseline", "vanilla", "ngram", "medusa", "eagle", "tree")
LAYOUTS = ("contiguous", "paged")
# Per-cell feature under test (one at a time, on top of mode x layout):
#   plain          — nothing extra
#   per_request    — per-request sampling params in DecodeState
#   lora           — multi-LoRA adapter pack
#   constrain      — grammar-constrained decoding (json)
#   prefix_caching — cross-request prompt page reuse
#   kv_ring        — rolling-buffer KV for sliding-window models
FEATURES = ("plain", "per_request", "lora", "constrain", "prefix_caching",
            "kv_ring")

PREFIX_NEEDS_PAGED = "prefix_caching requires kv_layout='paged'"
RING_NEEDS_CONTIGUOUS = "kv_ring requires kv_layout='contiguous'"
RING_NOT_IN_TREE = "kv_ring is not supported in tree mode"
CONSTRAIN_NOT_IN_TREE = "constrained decoding is not supported in tree mode"
LORA_NOT_IN_TREE = "LoRA is not supported in tree mode"
PER_REQUEST_NOT_WITH_REJECTION = "not supported with the rejection policy"
# The port's own rule in the matrix (port_refusals): a ring engine serves
# only with incremental admission.
RING_SERVING_NEEDS_ADMIT_CHUNK = "(kv_ring) needs admit_chunk"

# Each documented refusal of the matrix -> the port's raise site (file:line
# in llm_inference_lab_tpu_torch/), whose message holds the fragment.
RAISE_SITES: Dict[str, str] = {
    PREFIX_NEEDS_PAGED: "core/batching.py:601",  # ContinuousBatcher.__init__
    RING_NEEDS_CONTIGUOUS: "config.py:259",  # EngineConfig.validate
    RING_NOT_IN_TREE: "config.py:318",  # EngineConfig._validate_tree
    CONSTRAIN_NOT_IN_TREE: "config.py:295",  # EngineConfig._validate_constrain
    LORA_NOT_IN_TREE: "core/engine.py:387",  # Engine._build_lora
    PER_REQUEST_NOT_WITH_REJECTION: "config.py:276",  # EngineConfig.validate
}


def expected_error(mode: str, layout: str, feature: str,
                   policy: str = "longest_prefix") -> Optional[str]:
    """The documented incompatibility for this cell: a message fragment the
    raise must contain, or None when the cell is supported. JAX's rules,
    in its order (RAISE_SITES holds each one's raise site in the port),
    then the port's one rule inside the matrix (port_refusals)."""
    if feature == "prefix_caching" and layout != "paged":
        return PREFIX_NEEDS_PAGED
    if feature == "kv_ring":
        if layout == "paged":
            return RING_NEEDS_CONTIGUOUS
        if mode == "tree":
            return RING_NOT_IN_TREE
    if mode == "tree":
        if feature == "constrain":
            return CONSTRAIN_NOT_IN_TREE
        if feature == "lora":
            return LORA_NOT_IN_TREE
    if policy == "rejection" and feature == "per_request":
        return PER_REQUEST_NOT_WITH_REJECTION
    if feature == "kv_ring":
        return RING_SERVING_NEEDS_ADMIT_CHUNK
    return None


def port_refusals() -> List[Dict[str, str]]:
    """What the port refuses and JAX does not: each with the fragment its
    raise holds and its raise site (file:line in
    llm_inference_lab_tpu_torch/). The first is inside the matrix (its
    kv_ring cells on the contiguous layout), the others outside it."""
    return [
        {"name": "ring_serving_without_admit_chunk",
         "what": "a ContinuousBatcher over a rolling-buffer (kv_ring) engine without "
                 "admit_chunk (a one-shot prefill of a prompt longer than the ring would "
                 "overwrite rows its own queries still need)",
         "fragment": RING_SERVING_NEEDS_ADMIT_CHUNK, "site": "core/batching.py:616"},
        {"name": "moe_weight_quantization",
         "what": "int4/int8 weight quantization of a MoE model (JAX would quantize its "
                 "router, which its routing cannot read)",
         "fragment": "weight quantization of a MoE model", "site": "core/engine.py:207"},
        {"name": "tree_over_max_s",
         "what": "a tree whose verify chunk (num_nodes + 1 rows) exceeds MAX_TREE_S = 32 "
                 "on the card",
         "fragment": "takes at most 32", "site": "ops/flash_decode.py:112"},
        {"name": "embed_bits",
         "what": "embed_bits outside {4, 8}",
         "fragment": "embed_bits must be 4 or 8", "site": "config.py:242"},
        {"name": "lora_mlp_without_gated_mlp",
         "what": "a LoRA adapter on gate/up/down of a model without a gated MLP (JAX drops "
                 "those matrices)",
         "fragment": "MLP does not have", "site": "models/lora.py:140"},
        {"name": "unknown_config_key",
         "what": "a config file or override key that the port's EngineConfig lacks (JAX "
                 "drops it)",
         "fragment": "are not fields of the port's EngineConfig", "site": "config.py:346"},
        # Under a mesh (parallel/): what this slice does not shard.
        {"name": "mesh_seq_stage_expert_axes",
         "what": "a seq (ring attention), stage (pipeline) or expert axis above 1",
         "fragment": "mesh axis is not ported", "site": "parallel/mesh.py:161"},
        {"name": "mesh_shape_differs",
         "what": "an Engine given a mesh whose shape differs from its cfg.mesh_shape",
         "fragment": "differs from cfg.mesh_shape", "site": "core/engine.py:218"},
        {"name": "mesh_lora_under_model",
         "what": "LoRA adapters under the model axis (each site's delta would need the rank's "
                 "columns)",
         "fragment": "LoRA under tensor parallelism", "site": "core/engine.py:389"},
        {"name": "mesh_moe",
         "what": "a MoE model under any mesh (the expert axis of ops/moe.py)",
         "fragment": "a MoE model under a mesh is not sharded", "site": "core/engine.py:311"},
        {"name": "mesh_fake_under_model",
         "what": "the fake model under the model axis (no heads to shard)",
         "fragment": "the fake model has no heads to shard", "site": "core/engine.py:317"},
        {"name": "mesh_profiler_under_model",
         "what": "the profiler under the model axis (its phase breakdown captures CUDA graphs, "
                 "which cannot hold the axis's collectives)",
         "fragment": "the profiler under the model axis is not ported",
         "site": "core/engine.py:319"},
        {"name": "mesh_heads_do_not_split",
         "what": "a model whose heads, KV heads, MLP width or vocabulary do not split over "
                 "the model axis (JAX's GSPMD pads them)",
         "fragment": "does not split over the model axis", "site": "parallel/sharding.py:169"},
        {"name": "mesh_batch_does_not_split",
         "what": "a generate_batch whose prompts do not split over the data axis",
         "fragment": "rows do not split over the data axis", "site": "parallel/mesh.py:128"},
        {"name": "mesh_batcher_data_axis",
         "what": "a ContinuousBatcher on a data axis above 1 (its slots across data ranks need "
                 "the coordinator's decisions: MultiHostBatcher)",
         "fragment": "needs the coordinator's decisions", "site": "core/batching.py:592"},
        {"name": "mesh_slots_do_not_split",
         "what": "serving slots that do not split over the data axis",
         "fragment": "must split over the data axis", "site": "core/batching.py:595"},
        {"name": "multihost_prefix_caching",
         "what": "prefix caching under MultiHostBatcher on several ranks",
         "fragment": "prefix caching under MultiHostBatcher", "site":
             "core/multihost_batching.py:88"},
        {"name": "multihost_kv_ring",
         "what": "a rolling-buffer (kv_ring) engine under MultiHostBatcher on several ranks "
                 "(it serves only with incremental admission, which JAX's multi-host batcher "
                 "turns off)",
         "fragment": "under MultiHostBatcher on several ranks is not ported (it serves only",
         "site": "core/multihost_batching.py:91"},
        {"name": "multihost_cancel",
         "what": "cancel under MultiHostBatcher on several ranks (a coordinator-only write to "
                 "one rank's state)",
         "fragment": "cancel under MultiHostBatcher", "site": "core/multihost_batching.py:111"},
    ]


def cells():
    """Every (mode, layout, feature) cell of the matrix."""
    for mode in MODES:
        for layout in LAYOUTS:
            for feature in FEATURES:
                yield mode, layout, feature
