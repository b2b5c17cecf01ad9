"""Port parity: the int4 embedding and tied head (ops/quant.py EmbedQuant4,
repack_int4_rows, quantize_embed4, quantize_params(embed_bits=4), the
quantized init, checkpoints and Engine.generate with embed_bits=4) against
the JAX package on the CPU.

Bytes are held exactly: both layouts of the table, the scales, the lookup's
rows, a checkpoint's leaves. The head's logits are not: JAX computes them
through ``dense`` (ops/quant.py:300), which rounds a bf16 model's logits to
bf16; the port keeps them f32 (kernel A's f32 instantiation on the card,
its plain version here). So a bf16 row is held to JAX's within half a bf16
ulp of JAX's value plus the f32 summation bound of D terms, and an f32 row
(where JAX's dense keeps f32) within the summation bound alone. Greedy ids
of an f32 model equal JAX's: both heads are f32 there, and only a near tie
(two logits within the summation bound) could part them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import checkpoint as jck
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.llama import LLAMA_CONFIGS as J_LLAMA
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import checkpoint, transformer
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
from llm_inference_lab_tpu_torch.ops import quant
from test_torch_decode_loop import _jax_model, one_thread  # noqa: F401

V, D = 384, 128


def _table(seed=3):
    return np.random.default_rng(seed).normal(0, 0.05, (V, D)).astype(np.float32)


def _pair(seed=3):
    t = _table(seed)
    return jq.quantize_embed4(jnp.asarray(t)), quant.quantize_embed4(torch.from_numpy(t))


def test_quantize_embed4_bytes_equal_jax():
    """Both layouts and the scales, byte for byte; the row layout is the
    head layout's values repacked (JAX repack_int4_rows on random bytes)."""
    ref, got = _pair()
    assert got.shape == ref.shape == (V, D)
    np.testing.assert_array_equal(got.qt.data.numpy(), np.asarray(ref.qt.data))
    np.testing.assert_array_equal(got.qt.scale.numpy(), np.asarray(ref.qt.scale))
    np.testing.assert_array_equal(got.rq.numpy(), np.asarray(ref.rq))
    assert got.qt.data.is_contiguous() and got.rq.is_contiguous() and got.qt.bits == 4
    raw = np.random.default_rng(9).integers(-128, 128, (D // 2, V)).astype(np.int8)
    np.testing.assert_array_equal(quant.repack_int4_rows(torch.from_numpy(raw)).numpy(),
                                  np.asarray(jq.repack_int4_rows(jnp.asarray(raw))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_equal_jax(dtype):
    """The gathered rows, unpacked and scaled, exactly JAX's (f32 products,
    one rounding to the model dtype), for ids of every shape the forward
    gives ([B, S])."""
    ref, got = _pair()
    ids = np.random.default_rng(4).integers(0, V, (3, 7)).astype(np.int32)
    want = np.asarray(ref.lookup(jnp.asarray(ids), getattr(jnp, dtype)).astype(jnp.float32))
    have = got.lookup(torch.from_numpy(ids).long(), getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(have, want)


def _bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_head_logits_f32_within_jax_rounding(dtype):
    """f32 logits [5, V] from x of the model dtype: |port - JAX| <= (bf16
    only) half a bf16 ulp of JAX's value + D * 2^-24 * sum_d |x_d w_vd| *
    scale_v. The port's bf16-model logits are not bf16 values: most of them
    lie between two."""
    ref, got = _pair()
    x = np.random.default_rng(5).normal(0, 1, (5, D)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(ref.head_logits(jx), np.float32)
    have = got.head_logits(tx)
    assert have.dtype == torch.float32 and have.shape == (5, V)
    have = have.numpy()
    w = quant.dequantize(got.qt, torch.float32).numpy() / got.qt.scale.numpy()  # int values
    xs = tx.float().numpy()
    bound = D * 2.0 ** -24 * (np.abs(xs) @ np.abs(w)) * got.qt.scale.numpy() + 1e-30
    if dtype == "bfloat16":
        bound = bound + 0.5 * _bf16_ulp(want)
        off_grid = have != torch.from_numpy(have).bfloat16().float().numpy()
        assert off_grid.mean() > 0.9, off_grid.mean()
    err = np.abs(have - want)
    assert np.all(err <= bound), float((err - bound).max())


def test_quantize_params_embed_bits4_equal_jax():
    """quantize_params(include_embed=True, embed_bits=4) of the same f32
    llama-tiny params: the EmbedQuant4 table byte for byte, every int4
    projection's bytes too and its scales within one f32 ulp (JAX's jitted
    vmap over the layer stack rounds amax / 7 differently in the last bit;
    the stacked leaves' bytes do not move), the norms as they were."""
    m = _jax_model("llama-tiny", 1)
    ref = params_from_jax(jq.quantize_params(jax.tree_util.tree_map(lambda a: a, m.params),
                                             "int4", min_size=0, include_embed=True,
                                             embed_bits=4))
    got = quant.quantize_params(params_from_jax(m.params), "int4", min_size=0,
                                include_embed=True, embed_bits=4)
    assert isinstance(got["embed"], quant.EmbedQuant4)
    _same_tree(got["embed"], ref["embed"])
    assert sorted(got["layers"]) == sorted(ref["layers"])
    for name, want in ref["layers"].items():
        have = got["layers"][name]
        if isinstance(want, quant.QuantTensor):
            assert isinstance(have, quant.QuantTensor) and have.bits == want.bits == 4, name
            assert torch.equal(have.data, want.data), name
            np.testing.assert_array_max_ulp(have.scale.numpy(), want.scale.numpy(), maxulp=1)
        else:
            assert torch.equal(have, want), name


def _same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, quant.EmbedQuant4):
        assert isinstance(a, quant.EmbedQuant4), path
        _same_tree(a.qt, b.qt, path + ".qt")
        assert torch.equal(a.rq, b.rq), path
    elif isinstance(b, quant.QuantTensor):
        assert isinstance(a, quant.QuantTensor) and a.bits == b.bits, path
        assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale), path
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_quantized_init_embed4():
    """init_params_quantized(quantize_embed=4): an EmbedQuant4 of JAX's shapes
    and scale (0.02 / 7) whose row layout is its head layout repacked; the
    forward and the tied head run on it (f32 logits [B, S, V])."""
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama-tiny"], dtype=torch.float32)
    p = transformer.init_params_quantized(cfg, torch.Generator().manual_seed(0), "cpu",
                                          mode="int4", quantize_embed=4)
    e = p["embed"]
    jp = jt.init_params_quantized(dataclasses.replace(J_LLAMA["llama-tiny"], dtype=jnp.float32),
                                  jax.random.PRNGKey(0), mode="int4", quantize_embed=4)
    assert isinstance(e, quant.EmbedQuant4)
    assert tuple(e.qt.data.shape) == tuple(jp["embed"].qt.data.shape)
    assert tuple(e.rq.shape) == tuple(jp["embed"].rq.shape)
    assert torch.all(e.qt.scale == torch.tensor(0.02 / 7, dtype=torch.float32))
    assert torch.equal(e.rq, quant.repack_int4_rows(e.qt.data))
    m = Model(cfg, p)
    lg, _ = m.forward(torch.tensor([[1, 2, 3]]), torch.arange(3, dtype=torch.int32)[None],
                      m.init_cache(1, 32, "cpu"), torch.zeros(1, dtype=torch.int32))
    assert lg.dtype == torch.float32 and lg.shape == (1, 3, cfg.vocab_size)
    assert torch.isfinite(lg).all()


def _e4_params(dtype=jnp.bfloat16):
    p = jt.init_params(dataclasses.replace(J_LLAMA["llama-tiny"], dtype=dtype),
                       jax.random.PRNGKey(0))
    return jq.quantize_params(p, "int4", min_size=0, include_embed=True, embed_bits=4)


def test_checkpoint_from_jax_byte_equal(tmp_path):
    """A file JAX's save_params wrote loads into the port's tree byte-equal
    to params_from_jax of JAX's params (the row layout repacked on load);
    the port's own round trip is byte-equal, and JAX loads the port's file
    to the same bytes."""
    jp = _e4_params()
    path = str(tmp_path / "e4.safetensors")
    jck.save_params(jp, path)
    want = params_from_jax(jp)
    _same_tree(checkpoint.load_params(path), want)
    mine = str(tmp_path / "port.safetensors")
    checkpoint.save_params(want, mine)
    _same_tree(checkpoint.load_params(mine), want)
    _same_tree(params_from_jax(jck.load_params(mine)), want)


def _engines(k, **kw):
    """JAX's Engine and the port's on the same f32 llama-tiny weights (x10
    projections, jittered norms) quantized by JAX to int4 with an int4
    embedding: both run them as given (quantization None)."""
    target = _jax_model("llama-tiny", 1)
    target.params = jq.quantize_params(target.params, "int4", min_size=0, include_embed=True,
                                       embed_bits=4)
    draft = None
    if k:
        draft = _jax_model("llama-tiny", 11)
        draft.params = jq.quantize_params(draft.params, "int4", min_size=0, include_embed=True,
                                          embed_bits=4)
    cfg = dict(base_model="llama-tiny", draft_model="llama-tiny" if k else None,
               max_draft=k or 1, max_new_tokens=16, max_seq_len=256, dtype="float32", **kw)
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     draft_model=draft)
    eng = Engine(EngineConfig(**cfg), device="cpu", target_params=params_from_jax(target.params),
                 draft_params=params_from_jax(draft.params) if draft is not None else None)
    assert isinstance(eng.target.params["embed"], quant.EmbedQuant4)
    return jeng, eng


PROMPTS = ["The quick brown fox jumps over the lazy dog.", "int4 table check " * 3]


@pytest.mark.parametrize("k", [0, 2])
def test_generate_ids_equal_jax(k):
    """Baseline and K=2 spec ids, token logprobs within 1e-4, against JAX's
    Engine; then the port's 3-slot batcher gives each prompt its B=1 ids."""
    jeng, eng = _engines(k)
    for prompt in PROMPTS:
        want, got = jeng.generate(prompt), eng.generate(prompt)
        assert got["generated_ids"] == want["generated_ids"], prompt
        np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=1e-4)
    b = ContinuousBatcher(eng, n_slots=3)
    rids = [b.submit(p) for p in PROMPTS + PROMPTS[:1]]
    out = {r["req_id"]: r["generated_ids"] for r in b.run()}
    for rid, prompt in zip(rids, PROMPTS + PROMPTS[:1]):
        assert out[rid] == eng.generate(prompt)["generated_ids"], prompt


def test_config_accepts_embed_bits4_and_quantized_init_runs():
    """EngineConfig(quantize_embed=True, embed_bits=4) with a quantized int4
    init: spec ids equal the baseline's (greedy), logprobs finite."""
    cfg = EngineConfig(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2,
                       max_new_tokens=8, max_seq_len=256, quantization="int4",
                       quantized_init=True, quantize_embed=True, embed_bits=4)
    cfg.validate()
    eng = Engine(cfg, device="cpu")
    assert isinstance(eng.target.params["embed"], quant.EmbedQuant4)
    r = eng.generate(PROMPTS[0])
    b = Engine(dataclasses.replace(cfg, draft_model=None), device="cpu").generate(PROMPTS[0])
    assert r["generated_ids"] == b["generated_ids"]
    assert np.all(np.isfinite(r["token_logprobs"]))


def test_f32_instantiation_plain_version():
    """Kernel A's f32 instantiation's plain version is quant_matmul_plain with
    an f32 output: the scaled f32 sum, never rounded to x's dtype (its bf16
    rounding is the bf16 plain version's output), and it is the tied head's
    logits."""
    from llm_inference_lab_tpu_torch.ops.quant_matmul import quant_matmul_f32, quant_matmul_plain

    _, got = _pair()
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (3, D)).astype(np.float32))
    x = x.bfloat16()
    y = quant_matmul_f32(x, got.qt.data, got.qt.scale)
    assert y.dtype == torch.float32
    assert torch.equal(y, quant_matmul_plain(x, got.qt.data, got.qt.scale,
                                             out_dtype=torch.float32))
    assert torch.equal(y.bfloat16(), quant_matmul_plain(x, got.qt.data, got.qt.scale))
    tcfg = ModelConfig(name="h", vocab_size=V, n_layers=1, n_heads=2, n_kv_heads=2, d_model=D,
                       d_ff=D, tie_word_embeddings=True, dtype=torch.bfloat16)
    assert torch.equal(transformer.lm_head_logits(tcfg, {"embed": got}, x), y)
