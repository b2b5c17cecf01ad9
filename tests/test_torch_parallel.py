"""Port parity for tensor and data parallelism (parallel/mesh.py,
sharding.py, multihost.py; the sharded forward of models/transformer.py;
Engine under a mesh) against the JAX package on the CPU.

The sharding rules are held to JAX's (_spec_for on every leaf of JAX's
init_params of four families); each rank's shard_params leaf to the slice
numpy takes from the full JAX array (Megatron order: heads first for the
fused leaves; int4 row shards unpacked to the full tensor's rows exactly)
and the shards rebuild the full tree byte for byte; a TP forward on 2 and 4
gloo CPU ranks (JAX's tp_model shapes, tests/test_parallel.py:19-28, f32)
to JAX's unsharded forward at JAX's tolerance, rtol = atol = 2e-4, for a
prefill and decode chunks, int8 and int4 weights and the int8 and int4
embeddings; Engine.generate_batch under (data 2, model 2) on 4 ranks to
JAX's unsharded Engine (JAX's test_engine_with_mesh_end_to_end asserts
equal ids); shard_state's layout to JAX's shard_state on its 8 virtual CPU
devices; and every refusal under a mesh to its message. The ranks run
tests/torch_parallel_ranks.py (no JAX) through multihost.launch, each on
one thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.core.state import init_state as jax_init_state
from llm_inference_lab_tpu.models import gpt2 as j_gpt2
from llm_inference_lab_tpu.models import llama as j_llama
from llm_inference_lab_tpu.models import opt as j_opt
from llm_inference_lab_tpu.models import qwen2 as j_qwen2
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import Model as JaxModel
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.ops.quant import quantize_params as jax_quantize
from llm_inference_lab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from llm_inference_lab_tpu.parallel.sharding import _spec_for as jax_spec_for
from llm_inference_lab_tpu.parallel.sharding import shard_state as jax_shard_state
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.state import FIELDS, init_state
from llm_inference_lab_tpu_torch.models import llama
from llm_inference_lab_tpu_torch.models.base import Model, ModelConfig
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, EmbedQuant4, QuantTensor
from llm_inference_lab_tpu_torch.parallel.mesh import Mesh
from llm_inference_lab_tpu_torch.parallel.multihost import launch
from llm_inference_lab_tpu_torch.parallel.sharding import (
    _spec_for,
    shard_params,
    shard_state,
    unshard_params,
)
from functools import partial

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401

RTOL = ATOL = 2e-4  # JAX's (tests/test_parallel.py:73-75)
QUANT = {"f32": {}, "int8": dict(mode="int8"), "int4": dict(mode="int4"),
         "int8_embed8": dict(mode="int8", include_embed=True),
         "int4_embed4": dict(mode="int4", include_embed=True, embed_bits=4)}


def tp_config(model_ax: int, layers: int = 2, name: str = "tp-test") -> dict:
    """JAX's tp_model config (tests/test_parallel.py:19-28) as keywords."""
    return dict(name=name, arch="llama", vocab_size=256, n_layers=layers, n_heads=2 * model_ax,
                n_kv_heads=model_ax, d_model=16 * model_ax, d_ff=32 * model_ax,
                max_position_embeddings=256)


BIASES = ("b_qkv", "bo", "b_fc", "b_proj", "attn_norm_bias", "mlp_norm_bias",
          "final_norm_bias")


def jax_model(kw: dict, seed: int, quant: str = "f32"):
    cfg = JaxModelConfig(dtype=jnp.float32, **kw)
    params = jt.init_params(cfg, jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)
    for tree in (params, params["layers"]):  # biases jittered (JAX's init zeroes them)
        for name in BIASES:
            if name in tree:
                tree[name] = jnp.asarray(g.normal(0, 0.1, tree[name].shape), jnp.float32)
    if QUANT[quant]:
        q = dict(QUANT[quant])
        params = jax_quantize(params, q.pop("mode"), min_size=0, **q)
    return JaxModel(config=cfg, params=params, apply_fn=partial(jt.forward, cfg),
                    head_fn=partial(jt.lm_head_logits, cfg))


def port_config(kw: dict) -> ModelConfig:
    return ModelConfig(dtype=torch.float32, **kw)


def fake_mesh(n: int, r: int, data: int = 1, d: int = 0) -> Mesh:
    """Rank (d, r)'s view of a mesh, without a process group (shard_params
    and shard_state read only the shape and the coordinates)."""
    return Mesh({"data": data, "model": n}, d * n + r, {"data": d, "model": r}, "gloo")


# --------------------------------------------------------------- the rules
FAMILIES = {"llama": (j_llama.LLAMA_CONFIGS, "llama-tiny", {}),
            "qwen2": (j_qwen2.QWEN2_CONFIGS, "qwen2.5-0.5b",
                      dict(n_heads=14, n_kv_heads=2, d_model=112)),
            "gpt2": (j_gpt2.GPT2_CONFIGS, "gpt2", dict(n_heads=4, n_kv_heads=4, d_model=64)),
            "opt": (j_opt.OPT_CONFIGS, "opt-125m", dict(n_heads=4, n_kv_heads=4, d_model=64))}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_for_equals_jax_on_every_leaf(family):
    table, preset, cut = FAMILIES[family]
    cfg = dataclasses.replace(table[preset], n_layers=2, d_ff=128, vocab_size=256,
                              max_position_embeddings=512, dtype=jnp.float32, **cut)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) > 5
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        for stage in (False, True):
            for expert in (False, True):
                want = tuple(jax_spec_for(name, leaf.ndim, stage, expert))
                assert _spec_for(name, leaf.ndim, stage, expert) == want, (name, stage, expert)
        for ndim in range(1, 5):  # scale vectors and stacked leaves of other ranks
            assert _spec_for(name, ndim) == tuple(jax_spec_for(name, ndim)), (name, ndim)


# ------------------------------------------------------------- the shards
def np_unpack4(b: np.ndarray) -> np.ndarray:
    """v2 int4 bytes [.., K/2, N] -> values [.., K, N] (numpy's own)."""
    b = np.asarray(b, np.int8)
    return np.concatenate([(b & 0x0F).astype(np.int8) - 8, b >> 4], axis=-2)


def np_cols(name: str, N: int, kw: dict, r: int, n: int) -> np.ndarray:
    """Rank r's columns of a column-parallel leaf, heads first."""
    blk = lambda w, off=0: off + np.arange(r * w // n, (r + 1) * w // n)  # noqa: E731
    if name in ("w_qkv", "b_qkv"):
        dh = kw["d_model"] // kw["n_heads"]
        q, kv = kw["n_heads"] * dh, kw["n_kv_heads"] * dh
        return np.concatenate([blk(q), blk(kv, q), blk(kv, q + kv)])
    if name == "w_gate_up":
        return np.concatenate([blk(N // 2), blk(N // 2, N // 2)])
    return blk(N)


def expected_leaf(name: str, full, kw: dict, r: int, n: int):
    """What rank r holds of a full JAX leaf, by numpy: (kind, arrays)."""
    cols = {"w_qkv", "b_qkv", "w_gate_up", "w_fc", "b_fc", "lm_head"}
    rows = {"wo", "w_down", "w_proj"}
    if name == "embed":
        if hasattr(full, "qt"):
            V = full.qt.data.shape[-1]
            s = slice(r * V // n, (r + 1) * V // n)
            return [np.asarray(full.qt.data)[:, s], np.asarray(full.qt.scale)[s],
                    np.asarray(full.rq)[s]]
        if hasattr(full, "q"):
            V = full.q.shape[0]
            s = slice(r * V // n, (r + 1) * V // n)
            return [np.asarray(full.q)[s], np.asarray(full.scale)[s]]
        V = full.shape[0]
        return [np.asarray(full)[r * V // n:(r + 1) * V // n]]
    quant = hasattr(full, "bits")
    data = np.asarray(full.data) if quant else np.asarray(full)
    if name in cols:
        idx = np_cols(name, data.shape[-1], kw, r, n)
        return ([data[..., idx], np.asarray(full.scale)[..., idx]] if quant
                else [data[..., idx]])
    if name in rows:
        if quant and full.bits == 4:
            vals = np_unpack4(data)
            K = vals.shape[-2]
            return [vals[..., r * K // n:(r + 1) * K // n, :], np.asarray(full.scale)]
        K = data.shape[-2]
        got = data[..., r * K // n:(r + 1) * K // n, :]
        return [got, np.asarray(full.scale)] if quant else [got]
    return [np.asarray(full.data), np.asarray(full.scale)] if quant else [data]


def port_arrays(leaf):
    if isinstance(leaf, EmbedQuant4):
        return [leaf.qt.data, leaf.qt.scale, leaf.rq]
    if isinstance(leaf, EmbedQuant):
        return [leaf.q, leaf.scale]
    if isinstance(leaf, QuantTensor):
        return [leaf.data, leaf.scale]
    return [leaf]


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("quant", sorted(QUANT))
@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_equals_numpy_slices_and_rebuilds(n, quant):
    kw = tp_config(n)
    jm = jax_model(kw, seed=3, quant=quant)
    full = params_from_jax(jm.params)
    cfg = port_config(kw)
    parts = [shard_params(full, fake_mesh(n, r), cfg) for r in range(n)]
    jleaves = dict(flat(jm.params))
    for r, part in enumerate(parts):
        for key, leaf in flat(part):
            name = key[-1]
            want = expected_leaf(name, jleaves[key], kw, r, n)
            got = port_arrays(leaf)
            if isinstance(leaf, QuantTensor) and leaf.bits == 4 and name in ("wo", "w_down"):
                got = [torch.from_numpy(np_unpack4(leaf.data.numpy())), leaf.scale]
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{key} rank {r}")
            sharded = [a for a, b in zip(port_arrays(leaf), port_arrays(dict(flat(full))[key]))
                       if a is not b]
            for a in sharded:  # a copy of its own: contiguous, 16-byte aligned
                assert a.is_contiguous() and a.data_ptr() % 16 == 0, key
    rebuilt = dict(flat(unshard_params(parts, cfg)))
    for key, leaf in flat(full):
        for a, b in zip(port_arrays(rebuilt[key]), port_arrays(leaf), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), key


@pytest.mark.parametrize("n", [2, 3, 4])
def test_int4_row_shard_unpacks_to_the_rows_exactly(n):
    """Rows [r K/n, (r+1) K/n) of a packed int4 w_down (shard_params), a shard
    at 3 ranks straddling K/2 included, repacked at K/n, the scale whole."""
    g = np.random.default_rng(n)
    K, N = 192, 64
    data = torch.from_numpy(g.integers(-128, 128, (2, K // 2, N)).astype(np.int8))
    scale = torch.from_numpy(g.random((2, N)).astype(np.float32))
    vals = np_unpack4(data.numpy())
    cfg = ModelConfig(n_heads=n, n_kv_heads=n, d_model=16 * n, d_ff=K)
    for r in range(n):
        sh = shard_params({"layers": {"w_down": QuantTensor(data, scale, bits=4)}},
                          fake_mesh(n, r), cfg)["layers"]["w_down"]
        assert sh.data.shape == (2, K // n // 2, N) and sh.data.is_contiguous()
        np.testing.assert_array_equal(np_unpack4(sh.data.numpy()),
                                      vals[:, r * K // n:(r + 1) * K // n])
        assert torch.equal(sh.scale, scale)


# ------------------------------------------------------- the TP forward
TOKENS = np.random.default_rng(0).integers(0, 255, (2, 6)).astype(np.int32)
STEPS = (1, 3)  # a decode chunk of one token, then one of three


def jax_forward(jm, tokens, steps):
    """ranks._forward's calls through JAX's forward."""
    B, P = tokens.shape
    total = P + sum(steps)
    cache = jm.init_cache(B, -(-total // 32) * 32)
    out, pos = [], 0
    chunks = [tokens] + [(tokens[:, :s] + 7 * (i + 1)) % 256 for i, s in enumerate(steps)]
    for chunk in chunks:
        S = chunk.shape[1]
        positions = jnp.broadcast_to(pos + jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        lens = jnp.full((B,), pos, jnp.int32)
        logits, cache = jm.apply(jm.params, jnp.asarray(chunk, jnp.int32), positions, cache,
                                 lens)
        out.append(np.asarray(logits, np.float32))
        pos += S
    return out


def gpt2_config(n: int) -> dict:
    """tp_config's widths on GPT-2's architecture: LayerNorm and learned
    positions, a bias on every projection (bo and b_proj added once after
    the sum), the plain gelu MLP (w_fc, w_proj)."""
    return dict(tp_config(n), name="tp-gpt2", arch="gpt2", n_kv_heads=2 * n, act="gelu",
                use_learned_pos=True, use_bias=True)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_forward_equals_jax(n):
    kw = tp_config(n)
    models = {q: jax_model(kw, seed=5, quant=q) for q in QUANT}
    models["gpt2"] = jax_model(gpt2_config(n), seed=6)
    cases = {q: (port_config(gpt2_config(n) if q == "gpt2" else kw), params_from_jax(m.params))
             for q, m in models.items()}
    got = launch(ranks.tp_forward, n, args=(cases, TOKENS, STEPS), threads=1, timeout=300)
    for q, m in models.items():
        want = jax_forward(m, TOKENS, STEPS)
        for r in range(n):
            for i, (a, b) in enumerate(zip(got[r][q], want, strict=True)):
                assert np.array_equal(a, got[0][q][i]), (q, "rank", r, "differs from rank 0")
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{q} chunk {i}")


# ------------------------------------------------------------- the engine
def test_engine_under_data_and_model_equals_jax():
    """JAX's test_engine_with_mesh_end_to_end: (data 2, model 2) on 4 ranks,
    ids equal to JAX's unsharded Engine, with the mesh given and with the
    engine making it from EngineConfig.mesh_shape; and a sampled engine's
    ids under the mesh equal the port's own in one process (each row draws
    by its global row)."""
    tkw, dkw = tp_config(2, 2, "tp-target"), tp_config(2, 1, "tp-draft")
    target, draft = jax_model(tkw, seed=1), jax_model(dkw, seed=2)
    prompts = ["mesh prompt one", "mesh prompt two"]
    jax_eng = JaxEngine(JaxEngineConfig(implementation="hf", max_draft=2, max_new_tokens=8,
                                        dtype="float32"), target_model=target, draft_model=draft)
    want = [r["generated_ids"] for r in jax_eng.generate_batch(prompts)]
    configs = {"tp-target": port_config(tkw), "tp-draft": port_config(dkw)}
    tparams, dparams = params_from_jax(target.params), params_from_jax(draft.params)
    kw = dict(max_draft=2, max_new_tokens=8, dtype="float32", shard_draft=True,
              base_model="tp-target", draft_model="tp-draft")
    sampled = dict(kw, greedy=False, temperature=0.8, top_p=0.95)
    whole_draft = dict(kw, shard_draft=False)  # JAX's rule: the draft whole on every rank
    from_shape = dict(kw, mesh_shape={"data": 2, "model": 2})
    got = launch(ranks.engine_ids, 4,
                 args=(configs, [kw, sampled, whole_draft, from_shape], tparams, dparams,
                       prompts, {"data": 2, "model": 2}, (None, 7)),
                 threads=1, timeout=300)
    for r in range(4):
        for i in (0, 2, 3):
            assert got[r][i][None] == want, ("rank", r, "engine", i)
    # The sampled run against the port in one process.
    saved = dict(llama.LLAMA_CONFIGS)
    llama.LLAMA_CONFIGS.update(configs)
    try:
        one = Engine(EngineConfig(**sampled), device="cpu", target_params=tparams,
                     draft_params=dparams)
        ref = {s: [x["generated_ids"] for x in one.generate_batch(prompts, seed=s)]
               for s in (None, 7)}
    finally:
        llama.LLAMA_CONFIGS.clear()
        llama.LLAMA_CONFIGS.update(saved)
    assert ref[None] != ref[7]
    for r in range(4):
        assert got[r][1] == ref, ("rank", r)


def test_refusals_under_a_mesh():
    tkw = tp_config(2, 2, "tp-target")
    configs = {"tp-target": port_config(tkw)}
    kw = dict(max_draft=2, max_new_tokens=8, dtype="float32", base_model="tp-target",
              draft_model=None)
    got = launch(ranks.refusals, 4, args=(configs, kw, params_from_jax(jax_model(tkw, 1).params)),
                 threads=1, timeout=300)
    want = {"stage_seq": "ValueError: stage (pipeline) and seq (ring-attention) axes are mutually "
                         "exclusive",
            "too_small": "ValueError: mesh 4x1x1x1x2 needs 8 devices, have 4",
            "mesh_differs": "ValueError: the mesh given ({'data': 2, 'model': 2}) differs from "
                            "cfg.mesh_shape ({'model': 4})",
            "batcher_seq": "ContinuousBatcher",
            "multihost_stage": "MultiHostBatcher",
            "stage_paged": "ValueError: paged KV under pipeline parallelism is not supported",
            "batcher_data": "ValueError: a ContinuousBatcher on a mesh with a data axis",
            "slots_split": "ValueError: n_slots (3) must split over the data axis (2)",
            "batch_split": "ValueError: 3 rows do not split over the data axis of 2"}
    for r in range(4):
        for name, fragment in want.items():
            assert fragment in got[r].get(name, ""), (r, name, got[r].get(name))
        assert got[r]["auto_mesh"] == {"data": 1, "model": 4}
        assert ("submit" in got[r]) == ("cancel" in got[r]) == (r != 0)
        if r:
            assert "RuntimeError: submit() is coordinator-only" in got[r]["submit"]
            assert "RuntimeError: cancel() is coordinator-only" in got[r]["cancel"]


# ------------------------------------------------------------ shard_state
@pytest.mark.parametrize("paged", [False, True])
def test_shard_state_lays_out_as_jax(paged):
    """Every field both packages' states hold, and the caches' k, v and int8
    scales: the port's rank (d, m) share equals the block of the full state
    that JAX's shard_state puts on device (d, m) of a (data 2, model 2) mesh
    of its CPU devices. The paged table is the exception: JAX replicates
    it, the port keeps the rank's rows."""
    kw = tp_config(2)
    B, T, P = 4, 128, 32
    jmesh = jax_make_mesh(data=2, model=2)
    jm = jax_model(kw, seed=0)
    jstate = jax_shard_state(jax_init_state(jm, jm, B, T, kv_quantized=True, paged=paged,
                                            page_size=P), jmesh)
    model = Model(port_config(kw), {})
    full = init_state(model, model, B, T, "cpu", paged=paged, page_size=P, kv_dtype=torch.int8)
    g = torch.Generator().manual_seed(0)
    for t in [getattr(full, f) for f in FIELDS] + [full.target_cache.k, full.target_cache.k_scale]:
        if t.dtype.is_floating_point:
            t.copy_(torch.rand(t.shape, generator=g))
        elif t.dtype != torch.bool:
            t.copy_(torch.randint(0, 100, t.shape, generator=g, dtype=t.dtype))

    def jleaf(name):
        if name.startswith("cache."):
            return getattr(jstate.target_cache, name[6:])
        return getattr(jstate, name)

    def pleaf(state, name):
        if name.startswith("cache."):
            return getattr(state.target_cache, name[6:])
        return getattr(state, name)

    names = [f for f in FIELDS if hasattr(jstate, f)
             and tuple(getattr(jstate, f).shape) == tuple(getattr(full, f).shape)]
    names += ["cache.k", "cache.v", "cache.k_scale", "cache.v_scale"]
    assert {"tokens", "lengths", "active", "steps", "top_ids"} <= set(names)
    for d in range(2):
        for m in range(2):
            mine = shard_state(full, fake_mesh(2, m, data=2, d=d))
            dev = jmesh.devices[d, m]
            for name in names:
                leaf = jleaf(name)
                idx = leaf.sharding.devices_indices_map(leaf.shape)[dev]
                want = pleaf(full, name).numpy()[idx]
                got = pleaf(mine, name)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} at {(d, m)}")
                assert got.is_contiguous(), name
            if paged:
                table = full.target_cache.table
                assert torch.equal(mine.target_cache.table, table[d * 2:(d + 1) * 2])
                jt_ = jstate.target_cache.table
                assert jt_.sharding.shard_shape(jt_.shape) == tuple(jt_.shape)  # replicated
