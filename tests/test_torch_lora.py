"""Port parity: multi-LoRA (models/lora.py, the forward's four sites,
Engine(lora_adapters=...) and generate(adapter=...)) against the JAX
package on the CPU.

The adapters are JAX's tests/test_lora.py's (make_adapter from numpy
seeds, alpha cranked so a delta shifts the tiny model's argmax), built by
each package's own make_adapter from the same generator: the packs are
held leaf for leaf, exactly. The forward is JAX's llama-tiny (f32,
projections x10, jittered norms; test_torch_decode_loop.py's weights)
carried over with convert.params_from_jax; its logits are held within
LOGIT_TOL of the largest (both sum the same f32 products in another order;
the deltas are a second such sum). A base row (lora_ids -1) of a mixed
batch keeps the bits of the pack-free forward of the same batch: its delta
is an exact zero.

JAX drops an adapter's gate/up/down matrices on a model without a gated
MLP (its _mlp_block returns before _lora on Mixtral, GPT-2 and OPT):
``test_jax_drops_mlp_sites_without_a_gated_mlp`` shows it, and the port
refuses such an adapter (``test_port_refuses_mlp_sites_without_a_gated_mlp``).
"""

import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import lora as jl
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import Model as JaxModel
from llm_inference_lab_tpu.models.gpt2 import GPT2_CONFIGS as J_GPT2
from llm_inference_lab_tpu.models.mixtral import MIXTRAL_CONFIGS as J_MIXTRAL
from llm_inference_lab_tpu.models.opt import OPT_CONFIGS as J_OPT
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import lora, transformer
from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.models.gpt2 import GPT2_CONFIGS
from llm_inference_lab_tpu_torch.models.llama import LLAMA_CONFIGS
from llm_inference_lab_tpu_torch.models.mixtral import MIXTRAL_CONFIGS
from llm_inference_lab_tpu_torch.models.opt import OPT_CONFIGS
from llm_inference_lab_tpu_torch.utils.safetensors import save_file
from test_torch_decode_loop import _jax_model, one_thread  # noqa: F401

CFG = LLAMA_CONFIGS["llama-tiny"]
LOGIT_TOL = 5e-5  # of the largest |logit|: two f32 orders of the same sums


def adapters(pkg, cfg):
    """JAX's test adapters, built by `pkg`'s make_adapter (jl or lora)."""
    return [pkg.make_adapter(cfg, "math", rank=4, alpha=512.0, targets=("q", "v"),
                             rng=np.random.default_rng(1)),
            pkg.make_adapter(cfg, "code", rank=2, alpha=512.0,
                             targets=("q", "k", "v", "o", "gate", "up", "down"),
                             rng=np.random.default_rng(2))]


def _jax_target():
    return _jax_model("llama-tiny", 1)


def _packed_jax(weights="f32"):
    """JAX's llama-tiny with the test adapters' pack in its layers; weights
    "int8" or "int4": its projections quantized first (JAX's quantize_params,
    min_size 0), so the deltas ride kernel B's or A's plain version."""
    m = _jax_target()
    if weights != "f32":
        m.params = jq.quantize_params(m.params, weights, min_size=0)
    pack, names = jl.build_pack(m.config, adapters(jl, m.config), dtype=jnp.float32)
    params = dict(m.params, layers=dict(m.params["layers"], **pack))
    return JaxModel(config=m.config, params=params, apply_fn=partial(jt.forward, m.config),
                    head_fn=partial(jt.lm_head_logits, m.config)), names


def test_build_pack_leaves_equal_jax():
    """Every lora_A_<site> / lora_B_<site> leaf ([L, n, in, R] and
    [L, n, R, out], ranks zero-padded) and the name map, exactly; the
    carried-over JAX pack is the same tensors."""
    jm, names = _packed_jax()
    cfg = dataclasses.replace(CFG, dtype=torch.float32)
    pack, got_names = lora.build_pack(cfg, adapters(lora, cfg), dtype=torch.float32)
    assert got_names == names == {"math": 0, "code": 1}
    want = {k: v for k, v in jm.params["layers"].items() if k.startswith("lora_")}
    assert sorted(pack) == sorted(want) == sorted(
        f"lora_{ab}_{site}" for ab in "AB" for site in lora.SITES)
    for k, v in want.items():
        np.testing.assert_array_equal(pack[k].numpy(), np.asarray(v), err_msg=k)
        assert torch.equal(params_from_jax({"x": v})["x"], pack[k])


def _forward_jax(model, toks, lora_ids):
    B, S = toks.shape
    logits, _ = model.apply_fn(model.params, jnp.asarray(toks),
                               jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S)),
                               model.init_cache(B, 32), jnp.zeros((B,), jnp.int32),
                               lora_ids=None if lora_ids is None else jnp.asarray(lora_ids,
                                                                                  jnp.int32))
    return np.asarray(logits)


def _forward_port(params, toks, lora_ids):
    cfg = dataclasses.replace(CFG, dtype=torch.float32)
    m = Model(cfg, params)
    B, S = toks.shape
    logits, _ = m.forward(torch.from_numpy(toks), torch.arange(S, dtype=torch.int32)[None]
                          .repeat(B, 1), m.init_cache(B, 32, "cpu"),
                          torch.zeros((B,), dtype=torch.int32),
                          lora_ids=None if lora_ids is None else torch.tensor(lora_ids,
                                                                              dtype=torch.int32))
    return logits.numpy()


TOKS = np.tile(np.arange(1, 9, dtype=np.int32)[None], (3, 1))


@pytest.mark.parametrize("weights", ["f32", "int8", "int4"])
def test_forward_mixed_batch_equals_jax(weights):
    """Rows [-1, 0, 1] (base, math, code) in one batch, over f32, int8 (B)
    and int4 (A) projections: the logits within LOGIT_TOL of JAX's largest;
    each adapter bites (its rows move by more than 1e-3 of the largest
    logit)."""
    jm, _ = _packed_jax(weights)
    want = _forward_jax(jm, TOKS, [-1, 0, 1])
    got = _forward_port(params_from_jax(jm.params), TOKS, [-1, 0, 1])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)
    for row in (1, 2):
        assert np.abs(got[row] - got[0]).max() > 1e-3 * scale


def test_base_rows_keep_the_pack_free_bits():
    """The base row of a mixed batch, and a whole batch at -1, equal the
    forward of the same batch without a pack (or with lora_ids None) bit
    for bit: a base row's delta is an exact zero."""
    jm, _ = _packed_jax()
    packed = params_from_jax(jm.params)
    plain = params_from_jax(_jax_target().params)
    free = _forward_port(plain, TOKS, None)
    assert np.array_equal(_forward_port(packed, TOKS, [-1, 0, 1])[0], free[0])
    assert np.array_equal(_forward_port(packed, TOKS, [-1, -1, -1]), free)
    assert np.array_equal(_forward_port(packed, TOKS, None), free)


def test_lora_delta_reads_no_per_row_copy():
    """lora_delta equals JAX's gathered einsums (A[idx], B[idx]) row for row
    within f32 rounding, ids past the pack clip to its last adapter as
    JAX's, and -1 is an exact zero."""
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (3, 16, 4)).astype(np.float32)
    B_ = rng.normal(0, 1, (3, 4, 24)).astype(np.float32)
    x = rng.normal(0, 1, (4, 5, 16)).astype(np.float32)
    ids = np.array([-1, 0, 2, 7], np.int32)
    want = np.asarray(jl.lora_delta(jnp.asarray(A), jnp.asarray(B_), jnp.asarray(ids),
                                    jnp.asarray(x)))
    got = lora.lora_delta(torch.from_numpy(A), torch.from_numpy(B_), torch.from_numpy(ids),
                          torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[0] == 0.0)


def _engines(**kw):
    cfg = dict(base_model="llama-tiny", draft_model=None, max_new_tokens=10, max_seq_len=256,
               dtype="float32", **kw)
    target = _jax_target()
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                     lora_adapters=adapters(jl, target.config))
    tcfg = dataclasses.replace(CFG, dtype=torch.float32)
    eng = Engine(EngineConfig(**cfg), device="cpu", target_params=params_from_jax(target.params),
                 lora_adapters=adapters(lora, tcfg))
    return jeng, eng


def _merged(params, adapter):
    """The adapter merged into copies of the fused weights (JAX's test's
    ground truth): w_site + A @ B, layer by layer."""
    layers = dict(params["layers"])
    for site, key in (("qkv", "w_qkv"), ("o", "wo"), ("gate_up", "w_gate_up"),
                      ("down", "w_down")):
        w = adapter.weights.get(site)
        if w is not None:
            layers[key] = layers[key] + torch.from_numpy(np.einsum("lir,lro->lio", *w))
    return dict(params, layers=layers)


@pytest.mark.parametrize("adapter", [None, "math", "code"])
def test_generate_adapter_equals_jax_and_merged(adapter):
    """generate(adapter=...) ids equal JAX's Engine's, and an engine on the
    adapter's merged weights (the base with adapter None); the adapters'
    ids differ from the base's."""
    jeng, eng = _engines()
    prompt = "adapt me"
    want = jeng.generate(prompt, adapter=adapter)
    got = eng.generate(prompt, adapter=adapter)
    assert got["generated_ids"] == want["generated_ids"]
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=1e-4)
    params = eng.target.params
    base = {k: v for k, v in params["layers"].items() if not k.startswith("lora_")}
    base = dict(params, layers=base)
    merged_params = base if adapter is None else _merged(
        base, adapters(lora, eng.target.config)[eng.lora_names[adapter]])
    merged = Engine(dataclasses.replace(eng.config), device="cpu", target_params=merged_params)
    assert merged.generate(prompt)["generated_ids"] == got["generated_ids"]
    if adapter is not None:
        assert got["generated_ids"] != eng.generate(prompt)["generated_ids"]


def test_engine_leaves_given_params_and_refuses_unknown():
    """The pack goes into a copy of the target's params and layers dicts
    (the caller's stay pack-free); an unknown adapter raises ValueError
    with JAX's batcher message."""
    target = _jax_target()
    given = params_from_jax(target.params)
    eng = Engine(EngineConfig(base_model="llama-tiny", draft_model=None, max_seq_len=256,
                              dtype="float32"), device="cpu", target_params=given,
                 lora_adapters=adapters(lora, dataclasses.replace(CFG, dtype=torch.float32)))
    assert not lora.has_pack(given["layers"]) and lora.has_pack(eng.target.params["layers"])
    with pytest.raises(ValueError, match="unknown LoRA adapter 'ghost'"):
        eng.generate("x", adapter="ghost")


def _peft_dir(tmp_path, cfg):
    """A PEFT directory written by the port's safetensors writer: q and v of
    every layer, torch layout (lora_A [r, in], lora_B [out, r])."""
    rng = np.random.default_rng(5)
    r = 4
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    tensors = {}
    for i in range(cfg.n_layers):
        pre = f"base_model.model.model.layers.{i}.self_attn"
        for proj, out in (("q_proj", H * Dh), ("v_proj", KV * Dh)):
            tensors[f"{pre}.{proj}.lora_A.weight"] = torch.from_numpy(
                rng.normal(0, 0.1, (r, D)).astype(np.float32))
            tensors[f"{pre}.{proj}.lora_B.weight"] = torch.from_numpy(
                rng.normal(0, 0.1, (out, r)).astype(np.float32))
    adir = tmp_path / "my-adapter"
    os.makedirs(adir)
    save_file(tensors, str(adir / "adapter_model.safetensors"))
    (adir / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": 8}))
    return str(adir)


def test_peft_loader_equals_jax(tmp_path):
    """load_peft_adapter on a file the port wrote equals JAX's
    load_peft_adapter on it (name, every site's pair, exactly); an engine
    with cfg.lora_paths serves it by its directory's name."""
    path = _peft_dir(tmp_path, CFG)
    jcfg = _jax_target().config
    want = jl.load_peft_adapter(path, jcfg)
    got = lora.load_peft_adapter(path, CFG)
    assert got.name == want.name == "my-adapter"
    for site in lora.SITES:
        if want.weights[site] is None:
            assert got.weights[site] is None, site
            continue
        for a, b in zip(got.weights[site], want.weights[site]):
            np.testing.assert_array_equal(a, b, err_msg=site)
    eng = Engine(EngineConfig(base_model="llama-tiny", draft_model=None, max_seq_len=256,
                              max_new_tokens=4, lora_paths=[path]), device="cpu")
    assert eng.lora_names == {"my-adapter": 0}
    assert eng.generate("x", adapter="my-adapter")["generated_tokens"] == 4
    with pytest.raises(ValueError, match="not a local PEFT adapter directory"):
        EngineConfig(lora_paths=[str(tmp_path / "nowhere")]).validate()


def test_tree_mode_refuses_lora():
    """Tree mode refuses an adapter with JAX's message, in both packages."""
    target = _jax_target()
    cfg = dict(base_model="llama-tiny", draft_model=None, draft_mode="tree", max_seq_len=256,
               dtype="float32")
    with pytest.raises(ValueError, match="LoRA is not supported in tree mode"):
        JaxEngine(JaxEngineConfig(implementation="hf", **cfg), target_model=target,
                  lora_adapters=adapters(jl, target.config))
    with pytest.raises(ValueError, match="LoRA is not supported in tree mode"):
        Engine(EngineConfig(**cfg), device="cpu", target_params=params_from_jax(target.params),
               lora_adapters=adapters(lora, dataclasses.replace(CFG, dtype=torch.float32)))


# Two-layer cuts at narrow widths of each family without a gated MLP.
NARROW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
              max_position_embeddings=512)
NON_GATED = {"mixtral": (J_MIXTRAL["mixtral-tiny"], MIXTRAL_CONFIGS["mixtral-tiny"], {}),
             "gpt2": (J_GPT2["gpt2"], GPT2_CONFIGS["gpt2"], NARROW),
             "opt": (J_OPT["opt-125m"], OPT_CONFIGS["opt-125m"], NARROW)}


@pytest.mark.parametrize("family", sorted(NON_GATED))
def test_jax_drops_mlp_sites_without_a_gated_mlp(family):
    """The reference's fault: an adapter of gate, up and down only changes
    nothing on Mixtral, GPT-2 or OPT in JAX (logits with the adapter equal
    the base's, exactly), with no error."""
    jcfg, _, cut = NON_GATED[family]
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, **cut)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    mlp_only = jl.make_adapter(jcfg, "mlp", rank=4, alpha=512.0, targets=("gate", "up", "down"),
                               rng=np.random.default_rng(1))
    pack, _ = jl.build_pack(jcfg, [mlp_only], dtype=jnp.float32)
    packed = dict(params, layers=dict(params["layers"], **pack))
    model = JaxModel(config=jcfg, params=packed, apply_fn=partial(jt.forward, jcfg),
                     head_fn=partial(jt.lm_head_logits, jcfg))
    toks = TOKS[:1]
    np.testing.assert_array_equal(_forward_jax(model, toks, [0]), _forward_jax(model, toks, [-1]))


@pytest.mark.parametrize("family", sorted(NON_GATED))
def test_port_refuses_mlp_sites_without_a_gated_mlp(family):
    """The port refuses gate/up/down matrices where there is no gated MLP
    (build_pack, so the engine too), and takes q, k, v and o there: on that
    model they bite, as in JAX."""
    _, cfg, cut = NON_GATED[family]
    cfg = dataclasses.replace(cfg, dtype=torch.float32, **cut)
    bad = lora.make_adapter(cfg, "mlp", rank=4, targets=("q", "gate", "up", "down"),
                            rng=np.random.default_rng(1))
    with pytest.raises(ValueError, match="gate/up/down"):
        lora.build_pack(cfg, [bad])
    ok = lora.make_adapter(cfg, "attn", rank=4, alpha=512.0, targets=("q", "k", "v", "o"),
                           rng=np.random.default_rng(1))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pack, _ = lora.build_pack(cfg, [ok], dtype=torch.float32)
    m = Model(cfg, dict(params, layers=dict(params["layers"], **pack)))
    toks = torch.arange(1, 9, dtype=torch.int32)[None]
    pos = torch.arange(8, dtype=torch.int32)[None]

    def run(ids):
        return m.forward(toks, pos, m.init_cache(1, 32, "cpu"), torch.zeros(1, dtype=torch.int32),
                         lora_ids=torch.tensor(ids, dtype=torch.int32))[0]

    assert not torch.equal(run([0]), run([-1]))
