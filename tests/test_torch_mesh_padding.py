"""Port parity for sizes that do not split over a mesh axis
(parallel/sharding.py head_layout, ff_per_rank and the padded vocabulary
and experts; the head's padded columns cut in models/transformer.py;
ops/moe.py moe_expert over padded experts) against the JAX package on the
CPU, whose GSPMD pads such dims.

The shards: each rank's fused QKV and wo hold the query heads and KV heads
written out by hand here for one KV head at model 2 (replicated) and 6
heads over 2 KV heads at model 4 (each KV group padded with a zero head),
zero where padded; a quantized leaf's shard equals quantize of the float
leaf's shard (int8 and int4, padded MLP width and vocabulary: a padded
rank's bytes are what quantize gives for its padded slice); the ranks'
trees rebuild the full tree byte for byte (unshard_params drops the
padding); shard_state's KV heads. The forwards (one launch of 4 gloo ranks,
tests/torch_parallel_ranks.py, one thread each): f32 logits of a prefill
and two decode chunks within 1e-5 of JAX's unsharded forward for one KV
head, a vocabulary of 257 (with its int8 and int4 embedding, and on GPT-2's
architecture: learned positions, biases, LayerNorm) and an odd MLP width
(f32, int8) at model 2 (a data 2 x model 2 mesh, each data row
its rows), 6 heads over 2 KV heads and an MLP width of 102 (f32, int8,
int4) at model 4, and a 6-expert MoE at expert 4 (moe_expert too, against
JAX's moe_dense); Engine.generate_batch ids at those shapes equal JAX's
unsharded Engine exactly, the draft of one KV head left whole by JAX's
rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.ops.moe import moe_dense
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.state import init_state
from llm_inference_lab_tpu_torch.models.base import Model, RankConfig
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, EmbedQuant4, QuantTensor, dequantize
from llm_inference_lab_tpu_torch.ops.quant import quantize_params as port_quantize
from llm_inference_lab_tpu_torch.parallel.mesh import AXES, Mesh
from llm_inference_lab_tpu_torch.parallel.multihost import launch
from llm_inference_lab_tpu_torch.parallel.sharding import (
    head_layout,
    shard_config,
    shard_params,
    shard_state,
    unshard_params,
)

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_parallel import TOKENS, flat, jax_forward, jax_model, port_arrays, port_config

TOL = 1e-5  # f32: the ranks' partial sums add in another order
STEPS = (1, 3)


def kw(name: str, **over) -> dict:
    """A llama-architecture test config (the forwards' and the engines')."""
    base = dict(name=name, arch="llama", vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
                d_model=64, d_ff=128, max_position_embeddings=512)
    return dict(base, **over)


# name -> (config keywords, quantization (test_torch_parallel's QUANT), model axis)
CASES = {
    "kv1": (kw("pad-kv1", n_kv_heads=1), "f32", 2),
    "v257": (kw("pad-v257", vocab_size=257), "f32", 2),
    "v257_embed8": (kw("pad-v257", vocab_size=257), "int8_embed8", 2),
    "v257_embed4": (kw("pad-v257", vocab_size=257), "int4_embed4", 2),
    "gpt2_v257": (kw("pad-gpt2", arch="gpt2", n_kv_heads=4, act="gelu", use_learned_pos=True,
                     use_bias=True, vocab_size=257), "f32", 2),
    "ff101": (kw("pad-ff101", d_ff=101), "f32", 2),
    "ff101_int8": (kw("pad-ff101", d_ff=101), "int8", 2),
    "h6kv2": (kw("pad-h6kv2", n_heads=6, d_model=96), "f32", 4),
    "ff102": (kw("pad-ff102", d_ff=102), "f32", 4),
    "ff102_int8": (kw("pad-ff102", d_ff=102), "int8", 4),
    "ff102_int4": (kw("pad-ff102", d_ff=102), "int4", 4),
    "moe6": (kw("pad-moe6", d_ff=32, n_experts=6, experts_per_token=2), "f32", None),
}
MESH = {2: {"data": 2, "model": 2}, 4: {"model": 4}, None: {"expert": 4}}


def fake_mesh(n: int, r: int, axis: str = "model") -> Mesh:
    return Mesh({"data": 1, axis: n, **({} if axis == "model" else {"model": 1})}, r,
                {a: (r if a == axis else 0) for a in AXES}, "gloo")


@pytest.fixture(scope="module")
def models():
    """Each case's JAX model (seeded init, the biases jittered) and its port
    tree."""
    out = {}
    for name, (k, quant, _) in CASES.items():
        jm = jax_model(k, seed=7, quant=quant)
        out[name] = (jm, params_from_jax(jm.params))
    return out


# ------------------------------------------------------------- the shards
def _heads_expected(full: np.ndarray, k: dict, q_heads, kv_heads, dh: int) -> np.ndarray:
    """A rank's fused QKV columns by numpy: its query heads, K heads and V
    heads (-1 a zero head)."""
    H, KV = k["n_heads"], k["n_kv_heads"]
    zero = np.zeros(full.shape[:-1] + (dh,), full.dtype)

    def head(j, off):
        return zero if j < 0 else full[..., off + j * dh:off + (j + 1) * dh]

    return np.concatenate([head(j, 0) for j in q_heads] + [head(j, H * dh) for j in kv_heads]
                          + [head(j, (H + KV) * dh) for j in kv_heads], axis=-1)


# The layouts written out: rank -> (query heads, KV heads).
LAYOUTS = {"kv1": {0: ([0, 1], [0]), 1: ([2, 3], [0])},
           "h6kv2": {0: ([0, 1], [0]), 1: ([2, -1], [0]), 2: ([3, 4], [1]), 3: ([5, -1], [1])}}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_head_layouts_and_their_shards(models, name):
    """Replicated KV heads (one at model 2) and KV groups padded with a zero
    query head (6 over 2 at model 4): head_layout, the rank config, and each
    rank's w_qkv and wo from numpy's slices of the JAX arrays."""
    k, _, n = CASES[name]
    jm, full = models[name]
    cfg = port_config(k)
    dh = k["d_model"] // k["n_heads"]
    for r, (q_heads, kv_heads) in LAYOUTS[name].items():
        assert head_layout(k["n_heads"], k["n_kv_heads"], n, r) == (q_heads, kv_heads)
        rc = shard_config(cfg, fake_mesh(n, r))
        assert (rc.n_heads, rc.n_kv_heads, rc.head_dim) == (len(q_heads), len(kv_heads), dh)
        part = shard_params(full, fake_mesh(n, r), cfg)["layers"]
        w_qkv = np.asarray(jm.params["layers"]["w_qkv"])
        np.testing.assert_array_equal(part["w_qkv"].numpy(),
                                      _heads_expected(w_qkv, k, q_heads, kv_heads, dh))
        wo = np.asarray(jm.params["layers"]["wo"])
        rows = [wo[:, j * dh:(j + 1) * dh] if j >= 0 else np.zeros_like(wo[:, :dh])
                for j in q_heads]
        np.testing.assert_array_equal(part["wo"].numpy(), np.concatenate(rows, axis=1))


def _copy(tree: dict) -> dict:
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _same_tree(a: dict, b: dict) -> None:
    fb = dict(flat(b))
    assert sorted(dict(flat(a))) == sorted(fb)
    for key, leaf in flat(a):
        for x, y in zip(port_arrays(leaf), port_arrays(fb[key]), strict=True):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_unshard_rebuilds_every_padded_tree(models, name):
    """Every case's ranks' trees (model 2 or 4, or expert 4) rebuild the
    full tree byte for byte: the padding dropped, a replicated head taken
    once."""
    _, quant, n = CASES[name]
    full = models[name][1]
    cfg = port_config(CASES[name][0])
    axis, size = ("model", n) if n else ("expert", 4)
    parts = [shard_params(full, fake_mesh(size, r, axis), cfg) for r in range(size)]
    _same_tree(unshard_params(parts, cfg, {axis: size}), full)
    if axis == "expert":  # rank 3 holds two zero experts past the router's six columns
        stack = parts[3]["layers"]["w_gate_up"]
        assert stack.shape[1] == 2 and not stack.any()
        assert parts[3]["layers"]["w_router"].shape[-1] == 6


@pytest.mark.parametrize("name,mode", [("ff101", "int8"), ("ff102", "int8"), ("ff102", "int4"),
                                       ("v257", "int8"), ("v257", "int4")])
def test_quantized_shards_are_quantize_of_the_padded_slice(models, name, mode):
    """shard_params of the quantized tree (the port's quantize_params,
    min_size 0, the embedding included) against each rank's float shard: a
    column-split leaf's bytes and scales are quantize's of the float shard
    (a padded column's quantize's of zeros); a row-split leaf keeps the
    whole weight's column scales and dequantizes to the float shard of the
    dequantized weight (a padded row, int4 before its packing, zero)."""
    k, _, n = CASES[name]
    full = models[name][1]
    cfg = port_config(k)
    q = dict(mode=mode, min_size=0, include_embed=True, embed_bits=4 if mode == "int4" else 8)
    whole = port_quantize(_copy(full), **q)  # quantize_params replaces leaves in place
    deq = dict(full, layers={key: (dequantize(v, torch.float32) if isinstance(v, QuantTensor)
                                   else v) for key, v in whole["layers"].items()})
    rows = {"wo", "w_down"}
    for r in range(n):
        mesh = fake_mesh(n, r)
        got = dict(flat(shard_params(whole, mesh, cfg)))
        want = dict(flat(port_quantize(shard_params(full, mesh, cfg), **q)))
        want_rows = dict(flat(shard_params(deq, mesh, cfg)))
        for key, leaf in got.items():
            if key[-1] in rows:
                assert torch.equal(leaf.scale, whole["layers"][key[-1]].scale), key
                assert torch.equal(dequantize(leaf, torch.float32), want_rows[key]), key
                continue
            for x, y in zip(port_arrays(leaf), port_arrays(want[key]), strict=True):
                assert x.dtype == y.dtype and torch.equal(x, y), (key, r)


def test_rank_configs_of_the_padded_sizes(models):
    """A RankConfig and sharded params exist for one KV head at model 2, a
    vocabulary of 257 at model 2 and 6 experts at expert 4; the vocabulary
    stays the model's (the head's padded columns are cut after the
    gather)."""
    kv1 = shard_config(port_config(CASES["kv1"][0]), fake_mesh(2, 1))
    assert isinstance(kv1, RankConfig) and (kv1.n_heads, kv1.n_kv_heads) == (2, 1)
    v = port_config(CASES["v257_embed4"][0])
    for r in range(2):
        rc = shard_config(v, fake_mesh(2, r))
        assert rc.vocab_size == 257
        for name in ("v257", "v257_embed8", "v257_embed4"):
            embed = shard_params(models[name][1], fake_mesh(2, r), v)["embed"]
            rows = (embed.rq.shape[0] if isinstance(embed, EmbedQuant4)
                    else embed.q.shape[0] if isinstance(embed, EmbedQuant) else embed.shape[0])
            assert rows == 129, name
    moe = port_config(CASES["moe6"][0])
    for e in range(4):
        rc = shard_config(moe, fake_mesh(4, e, "expert"))
        assert isinstance(rc, RankConfig) and rc.ep.size == 4 and rc.n_experts == 6
        part = shard_params(models["moe6"][1], fake_mesh(4, e, "expert"), moe)["layers"]
        assert part["w_down"].shape[1] == 2


def test_shard_state_holds_the_ranks_kv_heads():
    """shard_state's KV heads at model 4 of a 2-KV-head state: rank r holds
    head r // 2 (JAX replicates the axis); an int8 cache's scales with
    them."""
    cfg = port_config(CASES["h6kv2"][0])
    model = Model(cfg, {})
    full = init_state(model, None, 2, 64, "cpu", kv_dtype=torch.int8)
    full.target_cache.k.copy_(torch.randint(-100, 100, full.target_cache.k.shape,
                                            generator=torch.Generator().manual_seed(0)))
    full.target_cache.k_scale.uniform_(generator=torch.Generator().manual_seed(1))
    for r in range(4):
        mine = shard_state(full, fake_mesh(4, r)).target_cache
        for a, b in ((mine.k, full.target_cache.k), (mine.k_scale, full.target_cache.k_scale)):
            assert torch.equal(a, b[:, :, r // 2:r // 2 + 1])


# ------------------------------------------------------- the ranks' run
PROMPTS = ["padded mesh prompt one", "padded mesh two"]
ENGINE = dict(max_draft=2, max_new_tokens=8, dtype="float32", max_seq_len=128)
# case -> EngineConfig fields beside ENGINE (a draft of the case's own shape).
ENGINES = {"kv1": dict(draft_model="pad-kv1-draft", shard_draft=True),
           "v257_embed8": dict(draft_model=None), "h6kv2": dict(draft_model=None),
           "ff102_int4": dict(draft_model=None), "moe6": dict(draft_model=None)}
T_ROWS, MOE_D, MOE_F = 6, 32, 24


def _moe_case():
    g = np.random.default_rng(22)
    x = g.normal(0, 1, (T_ROWS, MOE_D)).astype(np.float32)
    router = g.normal(0, 0.5, (MOE_D, 6)).astype(np.float32)
    gate_up = g.normal(0, 0.1, (6, MOE_D, 2 * MOE_F)).astype(np.float32)
    down = g.normal(0, 0.1, (6, MOE_F, MOE_D)).astype(np.float32)
    return x, router, gate_up, down


@pytest.fixture(scope="module")
def draft():
    """A one-layer draft of one KV head: whole on every rank (JAX's rule)."""
    k = kw("pad-kv1-draft", n_kv_heads=1, n_layers=1)
    return k, jax_model(k, seed=8)


@pytest.fixture(scope="module")
def fleet(models, draft):
    """Every multi-rank check of this file in one launch of 4 ranks."""
    dk, dm = draft
    items = []
    for n, shape in MESH.items():
        cases = {name: (port_config(CASES[name][0]), models[name][1])
                 for name in CASES if CASES[name][2] == n}
        items.append(("mesh_forward", (cases, TOKENS, STEPS, shape)))
    configs = {CASES[name][0]["name"]: port_config(CASES[name][0]) for name in ENGINES}
    configs["pad-kv1-draft"] = port_config(dk)
    dparams = params_from_jax(dm.params)
    for name, extra in ENGINES.items():
        kws = [dict(ENGINE, base_model=CASES[name][0]["name"], **extra)]
        items.append(("mesh_engine_ids", (configs, kws, models[name][1],
                                          dparams if extra["draft_model"] else None, PROMPTS,
                                          MESH[CASES[name][2]])))
    items.append(("expert_moe", (*_moe_case(), 2, {"expert": 4})))
    return launch(ranks.jobs, 4, args=(items,), threads=1, timeout=600)


def _rows(shape: dict, r: int) -> slice:
    """The token rows rank r runs under a mesh of `shape` (its data row's)."""
    d = shape.get("data", 1)
    per = TOKENS.shape[0] // d
    i = r // (4 // d)
    return slice(i * per, (i + 1) * per)


@pytest.mark.parametrize("n", list(MESH), ids=lambda n: f"model{n}" if n else "expert4")
def test_padded_forwards_equal_jax(models, fleet, n):
    shape = MESH[n]
    got = fleet[0][list(MESH).index(n)]
    names = [name for name in CASES if CASES[name][2] == n]
    for name in names:
        want = jax_forward(models[name][0], TOKENS, STEPS)
        for r in range(4):
            logits = fleet[r][list(MESH).index(n)][name][0]
            for i, (a, b) in enumerate(zip(logits, want, strict=True)):
                b = b[_rows(shape, r)]
                assert a.shape == b.shape, (name, i)
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                           err_msg=f"{name} rank {r} chunk {i}")
    assert names and got


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_ids_at_padded_shapes_equal_jax(models, draft, fleet, name):
    """Engine.generate_batch on the mesh equals JAX's unsharded Engine's ids
    on every rank."""
    extra = ENGINES[name]
    jax_draft = draft[1] if extra["draft_model"] else None
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **ENGINE,
                                     draft_model=None if jax_draft is None else "given"),
                     target_model=models[name][0], draft_model=jax_draft)
    want = [r["generated_ids"] for r in jeng.generate_batch(PROMPTS)]
    at = len(MESH) + list(ENGINES).index(name)
    for r in range(4):
        assert fleet[r][at] == [want], ("rank", r)


def test_moe_expert_over_padded_experts_equals_jax(fleet):
    """moe_expert of 6 experts at expert 4 (rank 3 holds two zero experts)
    within 1e-5 of JAX's moe_dense over the whole stacks."""
    want = np.asarray(moe_dense(*(jnp.asarray(a) for a in _moe_case()), top_k=2))
    for r in range(4):
        np.testing.assert_allclose(fleet[r][-1], want, rtol=TOL, atol=TOL)
        assert np.array_equal(fleet[r][-1], fleet[0][-1]), r


def test_padding_leaves_a_dividing_layout_as_it_was():
    """Sizes that split keep the block layout: heads [r H/n, (r+1) H/n) and
    KV heads [r KV/n, (r+1) KV/n) in order, no zero head."""
    for H, KV, n in ((8, 8, 4), (8, 2, 2), (32, 8, 4)):
        for r in range(n):
            q, kv = head_layout(H, KV, n, r)
            assert q == list(range(r * H // n, (r + 1) * H // n))
            assert kv == list(range(r * KV // n, (r + 1) * KV // n))
