"""The port's feature matrix (llm_inference_lab_tpu_torch/features.py)
against JAX's (llm_inference_lab_tpu/features.py).

Every (draft mode x KV layout x feature) cell runs JAX's cell config
(tests/test_feature_matrix.py ``_build_config``: llama-tiny, or
mistral-tiny for the ring, f32) through a one-slot ContinuousBatcher on the
CPU, or raises the fragment ``expected_error`` documents, and the port's
``expected_error`` equals JAX's in every cell and under the rejection
policy. Each documented raise site (``RAISE_SITES``, ``port_refusals``)
holds its fragment, and each of the port's own refusals raises it.
"""

import ast
import json
import os
import re

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu import features as jax_features
from llm_inference_lab_tpu_torch import features
from llm_inference_lab_tpu_torch.config import EngineConfig, load_config
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import lora
from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
from test_torch_decode_loop import one_thread  # noqa: F401

PACKAGE = os.path.join(os.path.dirname(__file__), "..", "llm_inference_lab_tpu_torch")


@pytest.fixture(scope="module")
def lora_dir(tmp_path_factory):
    """JAX's matrix adapter (tests/test_feature_matrix.py lora_dir): q of
    every llama-tiny layer, rank 2, written by the port's safetensors
    writer."""
    from llm_inference_lab_tpu_torch.utils.safetensors import save_file

    cfg = LLAMA_CONFIGS["llama-tiny"]
    rng = np.random.default_rng(5)
    r, H, Dh, D = 2, cfg.n_heads, cfg.head_dim, cfg.d_model
    tensors = {}
    for i in range(cfg.n_layers):
        pre = f"base_model.model.model.layers.{i}.self_attn"
        tensors[f"{pre}.q_proj.lora_A.weight"] = torch.from_numpy(
            rng.normal(0, 0.02, (r, D)).astype(np.float32))
        tensors[f"{pre}.q_proj.lora_B.weight"] = torch.from_numpy(
            rng.normal(0, 0.02, (H * Dh, r)).astype(np.float32))
    adir = tmp_path_factory.mktemp("adapters") / "matrix-adapter"
    os.makedirs(adir, exist_ok=True)
    save_file(tensors, str(adir / "adapter_model.safetensors"))
    (adir / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": 4}))
    return str(adir)


def _cell_config(mode, layout, feature, lora_dir):
    """JAX's cell config (tests/test_feature_matrix.py _build_config)."""
    ring = feature == "kv_ring"
    base = "mistral-tiny" if ring else "llama-tiny"
    cfg = dict(base_model=base, draft_model=base if mode == "vanilla" else None,
               draft_mode="vanilla" if mode == "baseline" else mode, max_draft=2,
               max_new_tokens=4, max_seq_len=512 if ring else 96, dtype="float32",
               kv_layout=layout, kv_page_size=16)
    if mode == "tree":
        cfg["tree"] = {"branching": [2]}
    if feature == "per_request":
        cfg["per_request_sampling"] = True
    elif feature == "lora":
        cfg["lora_paths"] = [lora_dir]
    elif feature == "constrain":
        cfg["constrain"] = "json"
    elif feature == "prefix_caching":
        cfg["prefix_caching"] = True
    elif feature == "kv_ring":
        cfg["kv_ring"] = True
        cfg["prefill_chunk"] = 32
    return cfg


def _serve_cell(cfg, feature):
    b = ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), n_slots=1)
    b.submit("matrix smoke prompt", max_new_tokens=3,
             **({"lora": "matrix-adapter"} if feature == "lora" else {}))
    (res,) = b.run()
    assert res["generated_tokens"] > 0, cfg


@pytest.mark.parametrize("mode,layout,feature", list(features.cells()))
def test_matrix_cell(mode, layout, feature, lora_dir):
    """The cell works through the batcher (a non-empty result), or raises
    the documented fragment. The port documents JAX's rule for every cell
    (the ring cells on the contiguous layout serve without admit_chunk)."""
    want = features.expected_error(mode, layout, feature)
    assert want == jax_features.expected_error(mode, layout, feature), (mode, layout, feature)
    cfg = _cell_config(mode, layout, feature, lora_dir)
    if want is not None:
        with pytest.raises((ValueError, NotImplementedError)) as err:
            ContinuousBatcher(Engine(EngineConfig(**cfg), device="cpu"), n_slots=1)
        assert want in str(err.value), (mode, layout, feature, err.value)
    if want is None:
        _serve_cell(cfg, feature)


def test_rejection_policy_excludes_per_request():
    """The policy rule (JAX's test_rejection_policy_excludes_per_request):
    the same fragment in both matrices, raised by the port's config."""
    want = features.expected_error("vanilla", "contiguous", "per_request", policy="rejection")
    assert want == jax_features.expected_error("vanilla", "contiguous", "per_request",
                                               policy="rejection")
    with pytest.raises(NotImplementedError, match=want):
        Engine(EngineConfig(base_model="llama-tiny", draft_model="llama-tiny",
                            policy="rejection", per_request_sampling=True, max_new_tokens=4,
                            max_seq_len=96, dtype="float32"), device="cpu")


def _raise_text(site):
    """The literal text of the exception message raised at `site`
    ("file:line" in the package): the string constants of its first
    argument (an f-string's formatted values left out)."""
    path, line = site.rsplit(":", 1)
    with open(os.path.join(PACKAGE, path)) as f:
        tree = ast.parse(f.read())
    raises = [node for node in ast.walk(tree)
              if isinstance(node, ast.Raise) and node.lineno == int(line)]
    assert len(raises) == 1, (site, "no raise statement starts at this line")
    arg = raises[0].exc.args[0]
    parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
    return "".join(p.value for p in parts if isinstance(p, ast.Constant))


@pytest.mark.parametrize("fragment", list(features.RAISE_SITES))
def test_matrix_raise_sites(fragment):
    """Each rule's cited raise site raises its fragment."""
    assert fragment in _raise_text(features.RAISE_SITES[fragment])


def _refuse_moe_quantization():
    Engine(EngineConfig(base_model="mixtral-tiny", draft_model=None, quantization="int8",
                        max_seq_len=96, dtype="float32"), device="cpu")


def _refuse_embed_bits():
    EngineConfig(embed_bits=2).validate()


def _refuse_lora_mlp():
    from llm_inference_lab_tpu_torch.models.registry import create

    gpt2 = create("gpt2", device="cpu", dtype=torch.float32)
    ad = lora.make_adapter(gpt2.config, "mlp", rank=2, targets=("q", "down"))
    lora.build_pack(gpt2.config, [ad], dtype=torch.float32)


def _refuse_config_key():
    load_config(None, max_draft=2, speculative_lookahead=3)


def _mesh(data=1, model=1):
    """Rank 0's view of a mesh, without a process group: every refusal below
    raises before a collective would run."""
    from llm_inference_lab_tpu_torch.parallel.mesh import AXES, Mesh

    return Mesh({"data": data, "model": model}, 0, {a: 0 for a in AXES}, "gloo")


TINY = dict(base_model="llama-tiny", draft_model=None, max_seq_len=96, dtype="float32")


def _mesh_engine(data=1, model=1, **kw):
    return Engine(EngineConfig(**dict(TINY, **kw)), device="cpu", mesh=_mesh(data, model))


def _refuse_slots():
    from llm_inference_lab_tpu_torch.core.multihost_batching import MultiHostBatcher

    MultiHostBatcher(_mesh_engine(data=2), n_slots=3)


REFUSE = {"moe_weight_quantization": _refuse_moe_quantization,
          "embed_bits": _refuse_embed_bits,
          "lora_mlp_without_gated_mlp": _refuse_lora_mlp,
          "unknown_config_key": _refuse_config_key,
          "mesh_shape_differs": lambda: _mesh_engine(data=2, mesh_shape={"model": 2}),
          "mesh_batch_does_not_split": lambda: _mesh_engine(data=2).generate_batch(["a"]),
          "mesh_batcher_data_axis": lambda: ContinuousBatcher(_mesh_engine(data=2), n_slots=2),
          "mesh_slots_do_not_split": _refuse_slots}


@pytest.mark.parametrize("refusal", features.port_refusals(), ids=lambda r: r["name"])
def test_port_refusals(refusal):
    """Each refusal the port adds to JAX's raises its fragment, and its cited
    raise site holds it; the list names exactly the refusals exercised
    here."""
    assert set(REFUSE) == {r["name"] for r in features.port_refusals()}
    assert refusal["fragment"] in _raise_text(refusal["site"])
    with pytest.raises((ValueError, NotImplementedError), match=re.escape(refusal["fragment"])):
        REFUSE[refusal["name"]]()
