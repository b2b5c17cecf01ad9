"""Port parity for serving under the seq and stage mesh axes (core/batching.py
ContinuousBatcher and core/multihost_batching.py MultiHostBatcher over a
cache split on T or on layers; paged KV and the tree under seq; kernel D's
shard variant with the ancestry word, the softcap and the window) against
the JAX package on the CPU.

One launch of 4 gloo ranks (tests/torch_parallel_ranks.py ``jobs``, one
thread each) runs every multi-rank case; a case on 2 ranks leaves ranks 2
and 3 idle. Weights: llama-tiny from the JAX factory with its matrices
scaled x4 and gemma2-tiny x2 (seed 3), so that greedy ids vary (asserted:
no request's ids are one token repeated), carried over with
convert.params_from_jax. Both packages' batchers are driven one step a poll
(``_serve_by_hand``; JAX's own loop times its polls by wall clock), and
each case's ids, finish reasons, prompt tokens reused, proposed, accepted
and admitted / retired counts equal JAX's single-process ContinuousBatcher
exactly, its token log-probs within 1e-4 + 3e-5 |lp| (the tolerance of
tests/test_torch_serving.py between the two f32 forwards). The cases, each
on a prompt of 85 tokens that crosses the 64-slot slices of a 128-slot
lane and one of 58 whose tree chunk straddles them:

  * ContinuousBatcher at seq=2: contiguous (vanilla K=2), an int8 KV cache
    with incremental admission (admit_chunk 32), paged with prefix
    caching, gemma2-tiny (window 16 binds; the score scale and the
    softcap), the tree [3, 2] contiguous and paged; at stage=2 contiguous;
  * MultiHostBatcher at data=2 x seq=2 and data=2 x stage=2, request 1
    cancelled after the second poll;
  * Engine.generate paged at seq=2 equals JAX's unsharded paged engine;
    JAX's own seq=2 paged engine gives other ids (its ring prefill writes
    the contiguous layout into the page pool: a fault of the reference,
    pinned here);
  * the tree [4, 3, 2] (40 nodes: a verify chunk of 41 rows, two ancestry
    words a row) at seq=2, its chunk straddling the slices: Engine.generate
    and the contiguous batcher give JAX's unsharded tree engine's and
    batcher's results;
  * mistral-tiny on its rolling-buffer cache (R = 128, window 16,
    prefill_chunk 32; a draft, K = 2) under MultiHostBatcher at data=2 and
    at model=2, whose admission is one-shot (a 153-token prompt, longer
    than the ring, in 5 back-to-back chunks): every rank gives one
    process's ContinuousBatcher's results (JAX's batcher cannot admit that
    prompt one-shot: tests/test_torch_ring_oneshot.py).

Each rank's cache holds its slice of T (seq) or its stage's layers (stage),
asserted by shape. The tree's KV compaction across slices (core/treespec.py
_compact on a seq group of 4) equals _compact over the whole cache, bit for
bit. The shard variants' plain versions (ops/flash_decode.py
flash_decode_shard_plain through flash_decode_shard_tree and
flash_decode_shard_opts on the CPU), over slices merged by log-sum-exp,
equal JAX's attend_xla over the whole cache within 1e-5 in f32: a tree
chunk that straddles a slice boundary, a slice past every row's chunk, and
Gemma-2's options with a slice wholly behind the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.batching import ContinuousBatcher as JaxBatcher
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models.registry import get_model
from llm_inference_lab_tpu.ops.attention import attend_xla
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    flash_decode_shard_opts,
    flash_decode_shard_tree,
    merge_shards,
)
from llm_inference_lab_tpu_torch.parallel.multihost import launch

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REQUESTS = [("seq axis serving " * 5, 8), ("x" * 58, 9), ("short one", 6),
            ("a third request", 7)]
PREFIX = "a shared prefix of thirty-two tok"
PREFIX_REQUESTS = [(PREFIX + "ens, then one", 8), ("seq axis serving " * 5, 6),
                   (PREFIX + "ens, and a much longer tail " * 2, 7)]
BASE = dict(base_model="llama-tiny", draft_model="llama-tiny", max_draft=2, max_new_tokens=12,
            max_seq_len=128, dtype="float32", eos_token_id=-1)
TREE = dict(BASE, draft_model=None, draft_mode="tree", tree={"branching": [3, 2]},
            medusa={"head_init": "random"})
CASES = {  # name: (EngineConfig fields, requests)
    "contiguous": (BASE, REQUESTS),
    "int8_incremental": (dict(BASE, kv_quantization="int8", admit_chunk=32), REQUESTS),
    "paged_prefix": (dict(BASE, kv_layout="paged", kv_page_size=16, prefix_caching=True),
                     PREFIX_REQUESTS),
    "gemma2": (dict(BASE, base_model="gemma2-tiny", draft_model="gemma2-tiny"),
               REQUESTS[:3] + [("a third request for the slots", 7)]),
    "tree": (TREE, REQUESTS),
    "tree_paged": (dict(TREE, kv_layout="paged", kv_page_size=16), REQUESTS),
}
RUNS = [(name, {"seq": 2}) for name in CASES] + [("contiguous", {"stage": 2})]
MULTIHOST = [{"data": 2, "seq": 2}, {"data": 2, "stage": 2}]
CANCEL = (1, 2)  # request 1, before the third poll
GENERATE = [("seq axis serving " * 5, 10)]
WIDE_TREE = dict(TREE, tree={"branching": [4, 3, 2]})
WIDE_REQUESTS = [("x" * 58, 9), ("short one", 6), ("a third request", 7)]  # chunk at 58: straddles
RING = dict(base_model="mistral-tiny", draft_model="mistral-tiny", max_draft=2, max_new_tokens=12,
            max_seq_len=512, prefill_chunk=32, kv_ring=True, dtype="float32", eos_token_id=-1)
RING_REQUESTS = [("ring cache check " * 9, 8), ("ring cache check " * 3, 8), ("short", 6),
                 ("a third request", 7)]
RING_MESHES = [{"data": 2}, {"model": 2}]
RING_GENERATE = RING_REQUESTS[:1]  # 153 tokens: longer than the ring of 128
# The fleet's cases after RUNS and MULTIHOST: the paged generate, the wide
# tree's generate and batcher, then the ring's MultiHostBatcher runs.
GEN_AT = len(RUNS) + len(MULTIHOST)
WIDE_AT = GEN_AT + 1
RING_AT = GEN_AT + 3
RING_STAGE_AT = RING_AT + len(RING_MESHES)


def _scaled(name: str, seed: int, mult: float):
    m = get_model(name, "hf", rng=jax.random.PRNGKey(seed), dtype=jnp.float32)
    m.params = jax.tree_util.tree_map(lambda a: a * mult if a.ndim >= 2 else a, m.params)
    return m


@pytest.fixture(scope="module")
def models():
    return {"llama-tiny": (_scaled("llama-tiny", 0, 4), _scaled("llama-tiny", 1, 4)),
            "gemma2-tiny": (_scaled("gemma2-tiny", 3, 2), _scaled("gemma2-tiny", 4, 2)),
            "mistral-tiny": (_scaled("mistral-tiny", 5, 4), _scaled("mistral-tiny", 6, 4))}


def _jax_engine(models, kw, **extra):
    target, draft = models[kw["base_model"]]
    kw = {k: v for k, v in kw.items() if k not in ("base_model", "draft_model")}
    return JaxEngine(JaxEngineConfig(implementation="hf", kv_lazy_pages=False, **kw, **extra),
                     target_model=target,
                     draft_model=draft if kw.get("draft_mode", "vanilla") == "vanilla" else None)


def _jax_served(eng, requests, n_slots=2, cancel=None):
    """JAX's batcher driven as the ranks drive the port's
    (torch_parallel_ranks._serve_by_hand): results and (admitted, retired)."""
    b = JaxBatcher(eng, n_slots=n_slots)
    for prompt, budget in requests:
        b.submit(prompt, max_new_tokens=budget)
    for poll in range(400):
        if cancel is not None and poll == cancel[1]:
            b.cancel(cancel[0])
        b._admit_pending()
        if not any(s is not None for s in b._slots) and not b.scheduler.pending():
            break
        b.step_chunk(1)
        b._retire_finished()
    stats = b.stats.report(n_slots)
    return [b._done[i].result for i in sorted(b._done)], (stats["admitted"], stats["retired"])


@pytest.fixture(scope="module")
def jax_served(models):
    """JAX's unsharded batcher on each case (and the tree's heads, which the
    port's engines are given)."""
    out, heads = {}, None
    for name, (kw, requests) in CASES.items():
        eng = _jax_engine(models, kw)
        if kw.get("draft_mode") == "tree":
            heads = params_from_jax(eng._draft_params)
        out[name] = _jax_served(eng, requests)
    out["multihost"] = _jax_served(_jax_engine(models, BASE), REQUESTS, n_slots=4,
                                   cancel=CANCEL)
    wide = _jax_engine(models, WIDE_TREE)
    out["wide_tree"] = _jax_served(wide, WIDE_REQUESTS)
    out["wide_tree_generate"] = [wide.generate(p, max_new_tokens=m)["generated_ids"]
                                 for p, m in WIDE_REQUESTS]
    return out, (heads, params_from_jax(wide._draft_params))


@pytest.fixture(scope="module")
def fleet(models, jax_served):
    heads, wide_heads = jax_served[1]

    def case(name, shape, kind="batcher", requests=None, cancel=None, **over):
        kw, reqs = CASES[name]
        target, draft = models[kw["base_model"]]
        tree = kw.get("draft_mode") == "tree"
        return {"kw": dict(kw, **over), "shape": shape, "target": params_from_jax(target.params),
                "draft": heads if tree else params_from_jax(draft.params),
                "requests": requests or reqs, "kind": kind, "cancel": cancel}

    cases = [case(name, shape) for name, shape in RUNS]
    cases += [case("contiguous", shape, "multihost", REQUESTS, CANCEL) for shape in MULTIHOST]
    cases.append(case("contiguous", {"seq": 2}, "generate", GENERATE, kv_layout="paged",
                      kv_page_size=16))
    target = params_from_jax(models["llama-tiny"][0].params)
    for kind in ("generate", "batcher"):
        cases.append({"kw": WIDE_TREE, "shape": {"seq": 2}, "target": target,
                      "draft": wide_heads, "requests": WIDE_REQUESTS, "kind": kind})
    cases += [_ring_case(models, shape) for shape in RING_MESHES]
    cases.append(_ring_case(models, {"stage": 2}, "generate", RING_GENERATE))
    items = [("serve_axes", ({}, cases)), ("compact_slices", (0, 4))]
    return launch(ranks.jobs, 4, args=(items,), threads=1, timeout=900)


def _ring_case(models, shape, kind="multihost", requests=RING_REQUESTS):
    target, draft = models["mistral-tiny"]
    return {"kw": RING, "shape": shape, "target": params_from_jax(target.params),
            "draft": params_from_jax(draft.params), "requests": requests, "kind": kind}


def _ring_one_process(models, case):
    """One process's ring engine (R = 128) on the case's weights."""
    eng = Engine(EngineConfig(**RING), device="cpu", target_params=case["target"],
                 draft_params=case["draft"])
    assert eng.target.config.kv_ring_len == 128
    return eng


def _same_results(got, want, what):
    for g, w in zip(got, want, strict=True):
        for key in ranks.SERVED_KEYS:
            if key != "token_logprobs":
                assert g[key] == w[key], (what, key, g[key], w[key])
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=3e-5,
                                   atol=1e-4, err_msg=str(what))


def _varied(results):
    """No request's ids are one token repeated."""
    for r in results:
        assert len(set(r["generated_ids"])) > 1, r["generated_ids"]


@pytest.mark.parametrize("run", range(len(RUNS)),
                         ids=[f"{name}-{'x'.join(f'{k}{v}' for k, v in shape.items())}"
                              for name, shape in RUNS])
def test_batcher_under_seq_and_stage_equals_jax(fleet, jax_served, run):
    """ContinuousBatcher at seq=2 (or stage=2) on both ranks: JAX's unsharded
    batcher's ids, finish reasons, reuse, proposed, accepted and counts,
    its log-probs within tolerance; each rank's cache is its slice of T
    (t0 = rank x 64) of its 2 slots or, under stage, its layer of two."""
    name, shape = RUNS[run]
    want, counts = jax_served[0][name]
    _varied(want)
    if name.startswith("tree"):
        assert sum(w["accepted"] for w in want) > 0
    if name == "paged_prefix":
        assert want[2]["prompt_tokens_reused"] == 32
    for r in range(2):
        got = fleet[r][0][run]
        _same_results(got["results"], want, (name, shape, r))
        assert got["stats"] == counts
        k = got["shape"]
        if "stage" in shape:
            assert k[0] == 1 and k[3] == 128 and got["t0"] is None
        elif "paged" in name:
            assert k[3] == 16 and got["t0"] is None  # the whole pool on every seq rank
        else:
            assert k[1:4] == (2, 2, 64) and got["t0"] == 64 * r
    assert fleet[2][0][run] is None and fleet[3][0][run] is None


@pytest.mark.parametrize("shape", MULTIHOST, ids=["data2xseq2", "data2xstage2"])
def test_multihost_under_seq_and_stage_equals_jax(fleet, jax_served, shape):
    """MultiHostBatcher at data=2 x seq=2 and data=2 x stage=2 (2 slots a
    data row; request 1 cancelled before the third poll): every rank gives
    JAX's unsharded batcher's results under the same cancel, and holds its
    slice of T or its stage's layer for its data row's 2 slots."""
    want, counts = jax_served[0]["multihost"]
    assert want[1]["finish_reason"] == "cancelled" and 0 < len(want[1]["generated_ids"]) < 9
    at = len(RUNS) + MULTIHOST.index(shape)
    for r in range(4):
        got = fleet[r][0][at]
        _same_results(got["results"], want, (shape, r))
        assert got["stats"] == counts
        if "seq" in shape:
            assert got["shape"][1:4] == (2, 2, 64) and got["t0"] == 64 * (r % 2)
        else:
            assert got["shape"][:2] == (1, 2) and got["t0"] is None


def test_paged_generate_under_seq_equals_jax_unsharded(fleet, models):
    """Engine.generate paged at seq=2 (the pool whole on every rank, the
    prefill unsplit) gives JAX's unsharded paged engine's ids."""
    want = [_jax_engine(models, BASE, kv_layout="paged", kv_page_size=16).generate(
        p, max_new_tokens=m)["generated_ids"] for p, m in GENERATE]
    assert len(set(want[0])) > 1
    for r in range(2):
        assert fleet[r][0][GEN_AT] == want, r


def test_wide_tree_under_seq_equals_jax(fleet, jax_served):
    """The tree [4, 3, 2] (S = 41) at seq=2, the 58-token prompt's chunk
    straddling the slices at 64: Engine.generate gives JAX's unsharded tree
    engine's ids, and the contiguous batcher its batcher's results and
    counts, on both ranks; some nodes are accepted."""
    want, counts = jax_served[0]["wide_tree"]
    assert sum(w["accepted"] for w in want) > 0
    for r in range(2):
        assert fleet[r][0][WIDE_AT] == jax_served[0]["wide_tree_generate"], r
        got = fleet[r][0][WIDE_AT + 1]
        _same_results(got["results"], want, ("wide tree", r))
        assert got["stats"] == counts
        assert got["shape"][1:4] == (2, 2, 64) and got["t0"] == 64 * r


@pytest.mark.parametrize("shape", RING_MESHES, ids=["data2", "model2"])
def test_ring_multihost_equals_one_process(fleet, models, shape):
    """MultiHostBatcher over mistral-tiny's ring (R = 128 slots on every
    rank) at data=2 (2 slots a data row) and model=2: its ranks' results
    are equal, and equal one process's ContinuousBatcher (the same slots,
    the same one-step polls), the 153-token prompt admitted one-shot past
    the ring."""
    case = _ring_case(models, shape)
    one = ContinuousBatcher(_ring_one_process(models, case), n_slots=2 * shape.get("data", 1))
    want = ranks._serve_by_hand(one, RING_REQUESTS)
    _varied(want)
    at = RING_AT + RING_MESHES.index(shape)
    runs = [fleet[r][0][at] for r in range(2)]
    assert runs[0]["results"] == runs[1]["results"]
    for r, got in enumerate(runs):
        _same_results(got["results"], want, (shape, r))
        assert got["shape"][3] == 128
    assert fleet[2][0][at] is None and fleet[3][0][at] is None


def _ring_generate_ids(eng):
    return [eng.generate(p, max_new_tokens=m)["generated_ids"] for p, m in RING_GENERATE]


def test_ring_generate_under_stage_equals_one_process(fleet, models):
    """mistral-tiny's ring (R = 128, a draft, K = 2) at stage=2, the
    153-token prompt longer than the ring: each stage writes its layers'
    rows at position mod R into its own layers of the ring, and both ranks
    give one process's ring generate's ids."""
    case = _ring_case(models, {"stage": 2}, "generate", RING_GENERATE)
    want = _ring_generate_ids(_ring_one_process(models, case))
    assert len(set(want[0])) > 1
    for r in range(2):
        assert fleet[r][0][RING_STAGE_AT] == want, r
    assert fleet[2][0][RING_STAGE_AT] is None and fleet[3][0][RING_STAGE_AT] is None


def test_jax_ring_under_stage_drops_its_pipeline(models):
    """Settled (ROADMAP item 10): JAX's engine at stage=2 binds forward_pp to
    the target (JAX core/engine.py:217-237), then _enable_kv_ring rebinds
    the ringed target's apply_fn to the plain forward (:489-491), so its
    ring never runs the pipeline: GSPMD runs the layer-sharded forward
    whole, and its ids equal its unsharded ring's and the port's one
    process's. The port's stages pipeline the ring
    (test_ring_generate_under_stage_equals_one_process)."""
    from llm_inference_lab_tpu.models import transformer as jax_transformer

    one = _jax_engine(models, RING)
    two = _jax_engine(models, RING, mesh_shape={"stage": 2})
    assert two.target.config.kv_ring_len == 128
    assert two.target.apply_fn.func is jax_transformer.forward
    want = _ring_generate_ids(_ring_one_process(models, _ring_case(models, {})))
    assert _ring_generate_ids(one) == _ring_generate_ids(two) == want


def test_jax_paged_generate_under_seq_is_its_fault(models):
    """Settled (ROADMAP Queue 3): JAX's own paged engine at seq=2 gives other
    ids than its unsharded paged engine, which the port gives. Its ring
    prefill writes with scatter_stack_layer, the contiguous layout, into
    the page pool (JAX models/transformer.py:174-180), which
    _cache_sharding replicates over seq (JAX parallel/sharding.py:146-147)."""
    prompt, budget = GENERATE[0]
    one = _jax_engine(models, BASE, kv_layout="paged", kv_page_size=16)
    two = _jax_engine(models, BASE, kv_layout="paged", kv_page_size=16,
                      mesh_shape={"seq": 2})
    assert (one.generate(prompt, max_new_tokens=budget)["generated_ids"]
            != two.generate(prompt, max_new_tokens=budget)["generated_ids"])


def test_tree_compaction_across_slices_equals_whole(fleet):
    """_compact over a cache split on T over 4 seq ranks, moves straddling
    the slices: each rank's slice equals its slice of the whole cache's
    compaction, int8 values and scales bit for bit."""
    for r in range(4):
        want, got = fleet[r][1]
        for w, g in zip(want, got, strict=True):
            assert torch.equal(w, g), r


def _slices(t, n):
    per = t.shape[2] // n
    return [(t[:, :, i * per:(i + 1) * per], i * per) for i in range(n)]


def _merged(fn, k, v, n):
    outs, lses = zip(*(fn(ks, vs, t0) for (ks, t0), (vs, _) in zip(_slices(k, n),
                                                                   _slices(v, n))))
    return merge_shards(torch.stack(outs), torch.stack(lses)), lses


def test_shard_tree_plain_equals_attend_xla():
    """flash_decode_shard_tree's plain version over 2 and 4 slices, merged:
    attend_xla's tree branch over the whole cache within 1e-5 (f32). Row b=0's
    chunk straddles the boundary at 16; b=1's chunk lies in the first
    slice, so the last slice sees none of its rows (lse -inf)."""
    rng = np.random.default_rng(0)
    B, S, H, KVH, D, T = 2, 10, 4, 2, 32, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, KVH, T, D), (B, KVH, T, D)))
    anc = np.tril(rng.random((S, S)) < 0.5) | np.eye(S, dtype=bool)
    start = np.array([12, 3], np.int32)
    want = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.zeros((B, S), jnp.int32), tree_mask=jnp.asarray(anc),
                                 chunk_start=jnp.asarray(start)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for n in (2, 4):
        (out, _), lses = _merged(lambda ks, vs, t0: flash_decode_shard_tree(
            tq, ks, vs, torch.from_numpy(anc), torch.from_numpy(start), t0), tk, tv, n)
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
        assert torch.isinf(lses[-1][1]).all()


def test_shard_options_plain_equals_attend_xla():
    """flash_decode_shard_opts' plain version (Gemma-2's scale, softcap 50
    and window 16 at D = 256) over 2 and 4 slices, merged: attend_xla over
    the whole cache with the same options within 1e-5 (f32); of 4 slices
    the first lies wholly behind every row's window (lse -inf)."""
    rng = np.random.default_rng(1)
    B, S, H, KVH, D, T = 2, 3, 4, 2, 256, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, KVH, T, D), (B, KVH, T, D)))
    pos = np.array([[40, 41, 42], [61, 62, 63]], np.int32)
    opts = dict(scale=224 ** -0.5, softcap=50.0, window=16)
    want = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), **opts))
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, pos))
    for n in (2, 4):
        (out, _), lses = _merged(lambda ks, vs, t0: flash_decode_shard_opts(
            tq, ks, vs, tp, t0, **opts), tk, tv, n)
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    assert torch.isinf(lses[0]).all()  # 4 slices: [0, 16) behind every window
