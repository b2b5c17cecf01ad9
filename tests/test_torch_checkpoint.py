"""Port parity for the checkpoint layer (models/checkpoint.py) against the
JAX package's models/checkpoint.py on the CPU: each package reads the
other's files to the same bytes, v1 int4 files migrate, and an int4
embedding in a v1 file raises (test_torch_embed4.py holds the v2 ones).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.models import checkpoint as jck
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.llama import LLAMA_CONFIGS as J_LLAMA
from llm_inference_lab_tpu.models.qwen2 import QWEN2_CONFIGS as J_QWEN2
from llm_inference_lab_tpu.ops.quant import QuantTensor as JaxQuantTensor
from llm_inference_lab_tpu.ops.quant import quantize_params as jax_quantize
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.models import checkpoint
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, QuantTensor
from llm_inference_lab_tpu_torch.utils.safetensors import SafeFile, save_file
from test_torch_decode_loop import one_thread  # noqa: F401

# A Qwen2-shaped tree (biases, an untied head) small enough for the CPU.
QWEN_SMALL = dataclasses.replace(J_QWEN2["qwen2.5-0.5b"], n_layers=2, n_heads=14, n_kv_heads=2,
                                 d_model=112, d_ff=128, vocab_size=256,
                                 tie_word_embeddings=False)


def _tree(quant, embed):
    """JAX params (bf16) of QWEN_SMALL, quantized with quantize_params
    (min_size 1000: the projections and the head) and, with embed, the
    int8 embedding."""
    p = jt.init_params(dataclasses.replace(QWEN_SMALL, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    p["layers"]["b_qkv"] = p["layers"]["b_qkv"] + 0.5  # not zeros
    if quant:
        p = jax_quantize(p, quant, min_size=1000, include_embed=embed)
    return p


def _same(a, b):
    """Two port trees with the same structure, leaf types and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, QuantTensor):
        assert isinstance(b, QuantTensor) and a.bits == b.bits
        assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
    elif isinstance(a, EmbedQuant):
        assert isinstance(b, EmbedQuant)
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), (a.dtype, b.dtype)


CASES = [(None, False), ("int8", False), ("int4", False), ("int4", True), ("int8", True)]


@pytest.mark.parametrize("quant,embed", CASES)
def test_port_loads_jax_files(tmp_path, quant, embed):
    """JAX's save_params -> the port's load_params: the tree params_from_jax
    gives, every leaf byte for byte (bf16 leaves, int4 and int8
    QuantTensors with their bits, the int8 EmbedQuant)."""
    tree = _tree(quant, embed)
    path = str(tmp_path / "ck.safetensors")
    jck.save_params(tree, path)
    _same(checkpoint.load_params(path), params_from_jax(tree))


@pytest.mark.parametrize("quant,embed", CASES)
def test_jax_loads_port_files(tmp_path, quant, embed):
    """The port's save_params -> JAX's load_params: the same tree again, and
    the port's own round trip too."""
    tree = params_from_jax(_tree(quant, embed))
    path = str(tmp_path / "ck.safetensors")
    checkpoint.save_params(tree, path)
    _same(params_from_jax(jck.load_params(path)), tree)
    _same(checkpoint.load_params(path), tree)
    assert SafeFile(path).metadata()["int4_fmt"] == "v2"


def test_v1_int4_file_migrates(tmp_path):
    """A v1 file (no int4_fmt marker; the low nibble two's complement): both
    packages load the v2 bytes; int8 data is left alone."""
    tree = params_from_jax(_tree("int4", False))
    tensors, quant = {}, {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            elif isinstance(v, QuantTensor):
                tensors[name + "/__qdata__"] = v.data ^ 0x08 if v.bits == 4 else v.data
                tensors[name + "/__qscale__"] = v.scale
                quant[name] = v.bits
            else:
                tensors[name] = v

    walk(tree, "")
    assert quant and set(quant.values()) == {4}
    path = str(tmp_path / "v1.safetensors")
    save_file(tensors, path, metadata={"quant": json.dumps(quant)})
    _same(checkpoint.load_params(path), tree)
    _same(params_from_jax(jck.load_params(path)), tree)


def test_int4_embedding_raises(tmp_path):
    """An int4 dual-layout embedding (EmbedQuant4, embed_bits=4) in a v1
    file (JAX's file without its int4_fmt marker) raises ValueError naming
    it: JAX's v1 migration keys on __qdata__ only, so its __e4data__ bytes
    would load unmigrated. The v2 file JAX wrote loads."""
    p = jt.init_params(dataclasses.replace(J_LLAMA["llama-tiny"], dtype=jnp.bfloat16),
                       jax.random.PRNGKey(0))
    p = jax_quantize(p, "int4", min_size=0, include_embed=True, embed_bits=4)
    path = str(tmp_path / "e4.safetensors")
    jck.save_params(p, path)
    f = SafeFile(path)
    meta = f.metadata()
    v1 = str(tmp_path / "e4_v1.safetensors")
    save_file({name: f.get(name) for name in f.keys()}, v1, metadata={"quant": meta["quant"]})
    with pytest.raises(ValueError, match="EmbedQuant4"):
        checkpoint.load_params(v1)
    assert checkpoint.load_params(path)["embed"].qt.bits == 4


def test_load_params_casts_and_places(tmp_path):
    """dtype casts the floating-point plain leaves only (quantized bytes and
    f32 scales stay), as JAX's dtype argument does."""
    tree = params_from_jax(_tree("int8", True))
    path = str(tmp_path / "ck.safetensors")
    checkpoint.save_params(tree, path)
    got = checkpoint.load_params(path, dtype=torch.float32)
    ref = jck.load_params(path, dtype=jnp.float32)
    assert got["layers"]["b_qkv"].dtype == torch.float32
    assert got["layers"]["w_qkv"].data.dtype == torch.int8
    assert got["embed"].scale.dtype == torch.float32
    np.testing.assert_array_equal(got["layers"]["b_qkv"].numpy(),
                                  np.asarray(ref["layers"]["b_qkv"]))
    assert isinstance(ref["layers"]["w_qkv"], JaxQuantTensor)
