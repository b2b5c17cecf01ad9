"""Port parity for the stage mesh axis (parallel/pipeline.py forward_pp, the
layer-axis sharding, Engine under stage) against the JAX package on the CPU,
after JAX's tests/test_pipeline_parallel.py.

forward_pp of gloo ranks (tests/torch_parallel_ranks.py, one thread each)
at stage 2 and 4 against JAX's forward_pp on its virtual CPU devices (JAX's
pp_model, f32, and its int8 and int4 weights; rtol = atol = 2e-4, JAX's),
for a prefill and two decode chunks, each stage's cache layers against
JAX's; microbatches 1, 2 and 4 agree with each other and with JAX's; data x
stage and stage x model; shard_params' layer slices against numpy's slices
of the JAX arrays at stage 2 and 4 and unshard_params' rebuild; Engine ids
at stage 2 (greedy, and ngram drafting) and stage 2 x model 2 against JAX's
Engine; and JAX's refusals under the stage axis, message for message.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import Model as JaxModel
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.models.llama import LlamaModel
from llm_inference_lab_tpu.models.lora import make_adapter as jax_make_adapter
from llm_inference_lab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from llm_inference_lab_tpu.parallel.pipeline import forward_pp as jax_forward_pp
from llm_inference_lab_tpu.parallel.sharding import shard_params as jax_shard_params
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models import llama
from llm_inference_lab_tpu_torch.models.base import ModelConfig
from llm_inference_lab_tpu_torch.models.lora import make_adapter
from llm_inference_lab_tpu_torch.parallel.mesh import AXES, Mesh
from llm_inference_lab_tpu_torch.parallel.multihost import launch
from llm_inference_lab_tpu_torch.parallel.pipeline import forward_pp
from llm_inference_lab_tpu_torch.parallel.sharding import shard_params, unshard_params

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_parallel import flat, port_arrays

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = ATOL = 2e-4  # JAX's (tests/test_pipeline_parallel.py)
PP_KW = dict(name="pp-test", arch="llama", vocab_size=128, n_layers=4, n_heads=4,
             n_kv_heads=2, d_model=32, d_ff=64, max_position_embeddings=128)
TOKENS = np.random.default_rng(3).integers(0, 127, (4, 8)).astype(np.int32)
STEPS = (1, 3)


def pp_model(quant=None) -> JaxModel:
    """JAX's pp_model (tests/test_pipeline_parallel.py:22-35)."""
    cfg = JaxModelConfig(dtype=jnp.float32, **PP_KW)
    rng = jax.random.PRNGKey(7)
    params = (jt.init_params_quantized(cfg, rng, mode=quant) if quant
              else jt.init_params(cfg, rng))
    return JaxModel(config=cfg, params=params, apply_fn=partial(jt.forward, cfg),
                    head_fn=partial(jt.lm_head_logits, cfg))


def jax_pp(jm, mesh_kw: dict, microbatches=None):
    """ranks.mesh_forward's chunks through JAX's forward_pp: the logits of
    each chunk and the final cache k."""
    mesh = jax_make_mesh(**mesh_kw)
    fn = jax.jit(partial(jax_forward_pp, jm.config, mesh, microbatches=microbatches))
    params = jax_shard_params(jm.params, mesh)
    B, P = TOKENS.shape
    cache = jm.init_cache(B, -(-(P + sum(STEPS)) // 32) * 32)
    out, pos = [], 0
    chunks = [TOKENS] + [(TOKENS[:, :s] + 7 * (i + 1)) % 256 for i, s in enumerate(STEPS)]
    for chunk in chunks:
        S = chunk.shape[1]
        positions = jnp.broadcast_to(pos + jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        logits, cache = fn(params, jnp.asarray(chunk, jnp.int32), positions, cache,
                           jnp.full((B,), pos, jnp.int32))
        out.append(np.asarray(logits, np.float32))
        pos += S
    return out, np.asarray(cache.k, np.float32)


QUANTS = {"f32": None, "int8": "int8", "int4": "int4"}
RUNS2 = [({"stage": 2}, False, None), ({"stage": 2}, False, 1), ({"stage": 2}, False, 2),
         ({"stage": 2}, False, 4)]
RUNS4 = [({"stage": 4}, False, None), ({"data": 2, "stage": 2}, False, None),
         ({"stage": 2, "model": 2}, False, None)]


@pytest.fixture(scope="module")
def pp_runs():
    """The port's forwards on 2 ranks (RUNS2: stage 2 by default, then at
    1, 2 and 4 microbatches) and on 4 ranks (RUNS4), each case's model on
    each rank."""
    models = {q: pp_model(quant) for q, quant in QUANTS.items()}
    cases = {q: (ModelConfig(dtype=torch.float32, **PP_KW), params_from_jax(m.params))
             for q, m in models.items()}
    two = launch(ranks.mesh_forward_runs, 2, args=(cases, TOKENS, STEPS, RUNS2), threads=1,
                 timeout=300)
    four = launch(ranks.mesh_forward_runs, 4,
                  args=({"f32": cases["f32"]}, TOKENS, STEPS, RUNS4), threads=1, timeout=300)
    return models, two, four


def _held(got_ranks, want, data=1, cache=None, shape=None):
    """Every rank's logits equal within its data row, and the rows in data
    order within JAX's tolerance of want; with cache, each rank's cache k
    against its block of JAX's (layers on stage, rows on data, heads on
    model)."""
    logits, ks = want
    n = len(got_ranks)
    per = n // data
    for i, w in enumerate(logits):
        rows = [got_ranks[d * per][0][i] for d in range(data)]
        for r in range(n):
            assert np.array_equal(got_ranks[r][0][i], rows[r // per]), ("rank", r, "chunk", i)
        np.testing.assert_allclose(np.concatenate(rows), w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"chunk {i}")
    if shape is not None:
        L, B, KVH = ks.shape[:3]
        st, m = shape.get("stage", 1), shape.get("model", 1)
        for r, g in enumerate(got_ranks):
            s_i, m_i = (r // m) % st, r % m
            d_i = r // (st * m)
            want_k = ks[s_i * L // st:(s_i + 1) * L // st, d_i * B // data:(d_i + 1) * B // data,
                        m_i * KVH // m:(m_i + 1) * KVH // m]
            np.testing.assert_allclose(g[1], want_k, rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("quant", sorted(QUANTS))
def test_forward_pp_at_stage_2_equals_jax(pp_runs, quant):
    models, two, _ = pp_runs
    want = jax_pp(models[quant], {"stage": 2})
    _held([g[0][quant] for g in two], want, shape={"stage": 2})


def test_forward_pp_at_stage_4_equals_jax(pp_runs):
    models, _, four = pp_runs
    _held([g[0]["f32"] for g in four], jax_pp(models["f32"], {"stage": 4}),
          shape={"stage": 4})


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_microbatch_schedules_agree(pp_runs, microbatches):
    """Each schedule within JAX's tolerance of JAX's at the same
    microbatches, and within 1e-5 of the default schedule (one row a
    microbatch): the rows' sums differ only by the CPU's f32 order at
    another M."""
    models, two, _ = pp_runs
    i = 1 + [1, 2, 4].index(microbatches)
    got = [g[i]["f32"] for g in two]
    _held(got, jax_pp(models["f32"], {"stage": 2}, microbatches))
    for a, b in zip(got[0][0], two[0][0]["f32"][0], strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_data_x_stage_equals_jax(pp_runs):
    models, _, four = pp_runs
    _held([g[1]["f32"] for g in four], jax_pp(models["f32"], {"data": 2, "stage": 2}), data=2,
          shape={"data": 2, "stage": 2})


def test_stage_x_model_equals_jax(pp_runs):
    models, _, four = pp_runs
    _held([g[2]["f32"] for g in four], jax_pp(models["f32"], {"stage": 2, "model": 2}),
          shape={"stage": 2, "model": 2})


def _stage_mesh(n: int, s: int, data: int = 1) -> Mesh:
    shape = {"data": data, "stage": n, "model": 1}
    return Mesh(shape, s, {a: (s if a == "stage" else 0) for a in AXES}, "gloo")


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_takes_each_stages_layers(n, quant):
    """Stage s holds layers [s L/n, (s+1) L/n) of every ['layers'] leaf (a
    QuantTensor's bytes and scales), numpy's slices of the JAX arrays, and
    every other leaf whole; the stages' trees rebuild the full tree byte for
    byte (unshard_params)."""
    jm = pp_model(QUANTS[quant])
    full = params_from_jax(jm.params)
    cfg = ModelConfig(dtype=torch.float32, **PP_KW)
    parts = [shard_params(full, _stage_mesh(n, s), cfg) for s in range(n)]
    jleaves = dict(flat(jm.params))
    for s, part in enumerate(parts):
        for key, leaf in flat(part):
            # The JAX leaf's arrays (numpy's, carried over as they are), sliced.
            want = port_arrays(params_from_jax({"x": jleaves[key]})["x"])
            if key[0] == "layers":
                want = [w[s * w.shape[0] // n:(s + 1) * w.shape[0] // n] for w in want]
            got = port_arrays(leaf)
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (key, "stage", s)
    rebuilt = dict(flat(unshard_params(parts, cfg, {"stage": n})))
    for key, leaf in flat(full):
        for a, b in zip(port_arrays(rebuilt[key]), port_arrays(leaf), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), key


# ------------------------------------------------------------- the engine
def _llama_tiny():
    """JAX's engine tests' target: llama-tiny from PRNGKey(5), f32."""
    return LlamaModel.create("llama-tiny", rng=jax.random.PRNGKey(5), dtype=jnp.float32)


ENGINE_KW = dict(draft_model=None, greedy=True, max_new_tokens=12, max_seq_len=128)
ENGINES = {"greedy": ({}, "pipeline parallel engine check"),
           "ngram": (dict(draft_mode="ngram", max_draft=4), "the cat sat. the cat sat. the")}


def test_engine_under_stage_equals_jax():
    """JAX's test_engine_pp_end_to_end, test_engine_pp_speculative and
    test_engine_pp_tp_end_to_end: Engine ids at stage 2 (greedy, then ngram
    drafting) and at stage 2 x model 2 equal JAX's Engine on the same mesh
    shape and weights (which equal its unsharded ids)."""
    jm = _llama_tiny()
    params = params_from_jax(jm.params)
    want, kws = {}, {}
    for name, (extra, prompt) in ENGINES.items():
        eng = JaxEngine(JaxEngineConfig(implementation="hf", mesh_shape={"stage": 2},
                                        **ENGINE_KW, **extra), target_model=_llama_tiny())
        want[name] = eng.generate(prompt)["generated_ids"]
        kws[name] = dict(ENGINE_KW, base_model="llama-tiny", dtype="float32", **extra)
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", mesh_shape={"stage": 2, "model": 2},
                                     **ENGINE_KW), target_model=_llama_tiny())
    want_tp = jeng.generate(ENGINES["greedy"][1])["generated_ids"]
    for n, shape, names in ((2, {"stage": 2}, list(ENGINES)),
                            (4, {"stage": 2, "model": 2}, ["greedy"])):
        got = launch(ranks.engine_prompts, n,
                     args=({}, [(kws[k], ENGINES[k][1]) for k in names], params, shape),
                     threads=1, timeout=300)
        for r in range(n):
            for k, ids in zip(names, got[r]):
                assert ids == (want[k] if n == 2 else want_tp), (shape, k, "rank", r)


def _stage_engine(**kw):
    return Engine(EngineConfig(**dict(ENGINE_KW, base_model="llama-tiny", dtype="float32", **kw)),
                  device="cpu", mesh=_stage_mesh(2, 0))


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    raise AssertionError("no refusal")


STAGE_REFUSALS = {"paged": dict(kv_layout="paged"), "tree": dict(draft_mode="tree")}


@pytest.mark.parametrize("what", sorted(STAGE_REFUSALS) + ["lora"])
def test_stage_refusals_keep_jax_messages(what):
    """JAX's refusals under the stage axis (engine.py:215-238, :421-425):
    paged KV, the tree and LoRA adapters, each with JAX's exception."""
    kw = STAGE_REFUSALS.get(what, {})
    jkw = dict(implementation="hf", mesh_shape={"stage": 2}, **ENGINE_KW, **kw)
    if what == "lora":
        jad = jax_make_adapter(_llama_tiny().config, "a", rank=2)
        pad = make_adapter(llama.LLAMA_CONFIGS["llama-tiny"], "a", rank=2)
        want = _message(lambda: JaxEngine(JaxEngineConfig(**jkw), target_model=_llama_tiny(),
                                          lora_adapters=[jad]))
        got = _message(lambda: Engine(
            EngineConfig(**dict(ENGINE_KW, base_model="llama-tiny", dtype="float32")),
            device="cpu", mesh=_stage_mesh(2, 0), lora_adapters=[pad]))
    else:
        want = _message(lambda: JaxEngine(JaxEngineConfig(**jkw), target_model=_llama_tiny()))
        got = _message(lambda: _stage_engine(**kw))
    assert got == want


def test_forward_pp_refuses_the_ring_prefill():
    """JAX's forward_pp refuses cp (pipeline.py:90-98); the port's raises
    the same before any collective."""
    jm = pp_model()
    with pytest.raises(NotImplementedError) as jerr:
        jax_forward_pp(jm.config, jax_make_mesh(stage=2), jm.params, None, None, None, None,
                       cp=(None, "seq"))
    with pytest.raises(NotImplementedError) as perr:
        forward_pp(ModelConfig(dtype=torch.float32, **PP_KW), {}, None, None, None, None, cp=True)
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------------------ shard_state
@pytest.mark.parametrize("shape", [{"stage": 2, "model": 2}, {"seq": 2, "model": 2},
                                   {"data": 2, "seq": 2}],
                         ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_shard_state_lays_out_stage_and_seq_as_jax(shape):
    """The caches' k, v and int8 scales of the port's rank share equal the
    block of the full state that JAX's shard_state (_cache_sharding: layers
    on stage, rows on data, KV heads on model, T on seq) puts on the same
    device of the mesh; under seq the slice's t0 is its first position."""
    from llm_inference_lab_tpu.core.state import init_state as jax_init_state
    from llm_inference_lab_tpu.parallel.sharding import shard_state as jax_shard_state
    from llm_inference_lab_tpu_torch.core.state import init_state
    from llm_inference_lab_tpu_torch.models.base import Model
    from llm_inference_lab_tpu_torch.parallel.sharding import shard_state

    kw = dict(PP_KW, n_layers=4)
    B, T = 4, 128
    jmesh = jax_make_mesh(**shape)
    jm = pp_model()
    jstate = jax_shard_state(jax_init_state(jm, jm, B, T, kv_quantized=True), jmesh)
    model = Model(ModelConfig(dtype=torch.float32, **kw), {})
    full = init_state(model, model, B, T, "cpu", kv_dtype=torch.int8)
    g = torch.Generator().manual_seed(0)
    for t in (full.target_cache.k, full.target_cache.v, full.target_cache.k_scale,
              full.target_cache.v_scale):
        t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))
    names = [a for a in AXES if a in jmesh.axis_names]
    for idx in np.ndindex(*jmesh.devices.shape):
        coords = dict(zip(names, idx))
        rank = int(np.ravel_multi_index(idx, jmesh.devices.shape))
        mshape = {a: shape.get(a, 1) for a in AXES if a in shape or a in ("data", "model")}
        mine = shard_state(full, Mesh(mshape, rank, {a: coords.get(a, 0) for a in mshape},
                                      "gloo"))
        dev = jmesh.devices[idx]
        for name in ("k", "v", "k_scale", "v_scale"):
            leaf = getattr(jstate.target_cache, name)
            sl = leaf.sharding.devices_indices_map(leaf.shape)[dev]
            want = getattr(full.target_cache, name).numpy()[sl]
            np.testing.assert_array_equal(getattr(mine.target_cache, name).numpy(), want,
                                          err_msg=f"{name} at {coords}")
        per = T // shape.get("seq", 1)
        assert mine.target_cache.t0 == (coords["seq"] * per if "seq" in shape else None)
