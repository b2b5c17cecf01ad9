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
# Each documented refusal of the matrix -> the port's raise site (file:line
# in llm_inference_lab_tpu_torch/), whose message holds the fragment.
RAISE_SITES: Dict[str, str] = {
    PREFIX_NEEDS_PAGED: "core/batching.py:619",  # ContinuousBatcher.__init__
    RING_NEEDS_CONTIGUOUS: "config.py:261",  # EngineConfig.validate
    RING_NOT_IN_TREE: "config.py:320",  # EngineConfig._validate_tree
    CONSTRAIN_NOT_IN_TREE: "config.py:297",  # EngineConfig._validate_constrain
    LORA_NOT_IN_TREE: "core/engine.py:428",  # Engine._build_lora
    PER_REQUEST_NOT_WITH_REJECTION: "config.py:278",  # EngineConfig.validate
}


def expected_error(mode: str, layout: str, feature: str,
                   policy: str = "longest_prefix") -> Optional[str]:
    """The documented incompatibility for this cell: a message fragment the
    raise must contain, or None when the cell is supported. JAX's rules,
    in its order (RAISE_SITES holds each one's raise site in the port)."""
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
    return None


def port_refusals() -> List[Dict[str, str]]:
    """What the port refuses and JAX does not: each with the fragment its
    raise holds and its raise site (file:line in
    llm_inference_lab_tpu_torch/), all outside the matrix."""
    return [
        {"name": "moe_weight_quantization",
         "what": "int4/int8 weight quantization of a MoE model (JAX would quantize its "
                 "router, which its routing cannot read)",
         "fragment": "weight quantization of a MoE model", "site": "core/engine.py:222"},
        {"name": "embed_bits",
         "what": "embed_bits outside {4, 8}",
         "fragment": "embed_bits must be 4 or 8", "site": "config.py:244"},
        {"name": "lora_mlp_without_gated_mlp",
         "what": "a LoRA adapter on gate/up/down of a model without a gated MLP (JAX drops "
                 "those matrices)",
         "fragment": "MLP does not have", "site": "models/lora.py:140"},
        {"name": "unknown_config_key",
         "what": "a config file or override key that the port's EngineConfig lacks (JAX "
                 "drops it)",
         "fragment": "are not fields of the port's EngineConfig", "site": "config.py:348"},
        # Under a mesh (parallel/): what the port does not shard.
        {"name": "mesh_shape_differs",
         "what": "an Engine given a mesh whose shape differs from its cfg.mesh_shape",
         "fragment": "differs from cfg.mesh_shape", "site": "core/engine.py:233"},
        {"name": "mesh_batch_does_not_split",
         "what": "a generate_batch whose prompts do not split over the data axis",
         "fragment": "rows do not split over the data axis", "site": "parallel/mesh.py:223"},
        {"name": "mesh_batcher_data_axis",
         "what": "a ContinuousBatcher on a data axis above 1 (its slots across data ranks need "
                 "the coordinator's decisions: MultiHostBatcher)",
         "fragment": "needs the coordinator's decisions", "site": "core/batching.py:610"},
        {"name": "mesh_slots_do_not_split",
         "what": "serving slots that do not split over the data axis",
         "fragment": "must split over the data axis", "site": "core/batching.py:613"},
    ]


def cells():
    """Every (mode, layout, feature) cell of the matrix."""
    for mode in MODES:
        for layout in LAYOUTS:
            for feature in FEATURES:
                yield mode, layout, feature
