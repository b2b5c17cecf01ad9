"""Penalties, logit_bias, per-row filters and top-N logprobs (ops/sampling.py,
core/specstep.py's _Controls, core/treespec.py, core/batching.py's
per-request controls) against the JAX package on the CPU.

The ops on seeded numpy inputs: token_counts, apply_penalties and
logit_bias_row equal JAX's exactly; the per-row filtered_logits gives JAX's
dynamic path's -inf mask with the same finite values. Greedy spec decoding
under penalties equals the penalized baseline and JAX's engine. The
batcher's greedy ids with per-request penalties and biases equal JAX's
batcher's exactly (paged and contiguous, vanilla K=2 and ngram K=3) on
llama-tiny f32 (weights carried over by convert.params_from_jax,
projections x10, test_torch_decode_loop.py's), through the same admit /
step / retire calls. Top-N logprobs in generate, the batcher and the tree:
ids exact, values within 1e-4 of JAX's (the bound the parity tests hold
the port's token logprobs to: two f32 forwards), the first alternative the
committed token with the port's own token logprob. The tree refuses
penalties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.ops import sampling as js
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.ops import sampling as ts
from test_torch_lazy_pages import jax_batcher, one_thread, port_engine  # noqa: F401

V = 300


def _rng(seed):
    return np.random.default_rng(seed)


def test_token_counts_equal_jax():
    """Counts of the committed prefix (ids past a row's length ignored, ids
    outside the vocabulary clipped as JAX clips them)."""
    rng = _rng(1)
    tokens = rng.integers(0, V + 5, (4, 40)).astype(np.int32)
    lengths = np.array([0, 7, 40, 23], np.int32)
    got = ts.token_counts(torch.from_numpy(tokens), torch.from_numpy(lengths), V).numpy()
    want = np.asarray(js.token_counts(jnp.asarray(tokens), jnp.asarray(lengths), V))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[0].sum() == 0 and got[2].sum() == 40


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
@pytest.mark.parametrize("rank", [2, 3], ids=["[B, V]", "[B, K+1, V]"])
def test_apply_penalties_equals_jax(per_row, rank):
    """HF repetition and OpenAI presence / frequency, scalars or one value a
    row, on [B, V] logits or verify windows [B, K+1, V] with [B, V] counts
    or a count per row: bit for bit JAX's."""
    rng = _rng(2 + rank)
    B = 4
    shape = (B, V) if rank == 2 else (B, 3, V)
    logits = (rng.normal(0, 3, shape)).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32) * (rng.random((B, V)) < 0.2)
    if per_row:
        pen = [rng.uniform(0.5, 2.0, B).astype(np.float32), rng.uniform(-1, 1, B).astype(
            np.float32), rng.uniform(-1, 1, B).astype(np.float32)]
        pen[0][0], pen[1][0], pen[2][0] = 1.0, 0.0, 0.0  # a row with every penalty off
        tp, jp = [torch.from_numpy(p) for p in pen], [jnp.asarray(p) for p in pen]
    else:
        tp = jp = [1.3, 0.4, 0.2]
    got = ts.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts), *tp).numpy()
    want = np.asarray(js.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), *jp))
    np.testing.assert_array_equal(got, want)
    if per_row:  # the row with the penalties off is the identity
        np.testing.assert_array_equal(got[0], logits[0])
    assert (got != logits).any()
    if rank == 3:  # a count per verify row
        window = np.repeat(counts[:, None], 3, axis=1)
        window[:, 1:] += 1
        got = ts.apply_penalties(torch.from_numpy(logits), torch.from_numpy(window), *tp).numpy()
        want = np.asarray(js.apply_penalties(jnp.asarray(logits), jnp.asarray(window), *jp))
        np.testing.assert_array_equal(got, want)


def test_logit_bias_equals_jax():
    """The dense bias row of (id, value) pairs (id -1 empty) and its sum
    with [B, V] and [B, K+1, V] logits: bit for bit JAX's."""
    rng = _rng(4)
    ids = rng.integers(-1, V, (3, 32)).astype(np.int32)
    ids[2] = -1  # a slot with no bias
    for b in range(2):  # distinct ids a row, as a request's dict gives
        live = ids[b] >= 0
        ids[b, live] = rng.permutation(V)[:live.sum()]
    vals = rng.uniform(-100, 100, (3, 32)).astype(np.float32)
    row = ts.logit_bias_row(torch.from_numpy(ids), torch.from_numpy(vals), V).numpy()
    np.testing.assert_array_equal(row, np.asarray(js.logit_bias_row(jnp.asarray(ids),
                                                                    jnp.asarray(vals), V)))
    assert not row[2].any()
    for shape in ((3, V), (3, 4, V)):
        logits = rng.normal(0, 2, shape).astype(np.float32)
        got = ts.apply_logit_bias(torch.from_numpy(logits), torch.from_numpy(ids),
                                  torch.from_numpy(vals)).numpy()
        want = np.asarray(js.apply_logit_bias(jnp.asarray(logits), jnp.asarray(ids),
                                              jnp.asarray(vals)))
        np.testing.assert_array_equal(got, want)


def test_per_row_filtered_logits_equal_jax_dynamic_path():
    """The per-row path (one descending sort a row): rows with top_k on and
    off, top_p on and at 1.0, min_p on and off, temperatures from 0.3 to
    2, on [B, V] and [B, K+1, V]: JAX's -inf mask exactly, the finite
    values within 1 f32 ulp (both divide by the same temperature)."""
    rng = _rng(5)
    B = 6
    params = dict(temperature=np.array([0.3, 1.0, 2.0, 0.7, 1.0, 1.3], np.float32),
                  top_k=np.array([0, 5, 40, 0, 1, 300], np.int32),
                  top_p=np.array([1.0, 0.9, 0.5, 0.3, 1.0, 0.95], np.float32),
                  min_p=np.array([0.0, 0.0, 0.05, 0.1, 0.0, 0.02], np.float32))
    for shape in ((B, V), (B, 2, V)):
        logits = rng.normal(0, 2, shape).astype(np.float32)
        got = ts.filtered_logits(torch.from_numpy(logits),
                                 **{k: torch.from_numpy(v) for k, v in params.items()}).numpy()
        want = np.asarray(js.filtered_logits(jnp.asarray(logits),
                                             **{k: jnp.asarray(v) for k, v in params.items()}))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_array_less(np.abs(got[fin] - want[fin]),
                                     np.spacing(np.abs(want[fin])) * 1.0001 + 1e-30)
        kept = np.isfinite(got).reshape(-1, V).sum(axis=1)
        assert kept.min() >= 1 and kept.max() == V  # filters bite, and a row keeps all


def test_per_row_sampling_follows_each_rows_distribution():
    """Rows with their own parameters and keys: 2**15 draws a row within
    total variation 0.02 of exp(log_softmax(JAX's per-row filtered logits))
    (JAX's bound for its own sampler); a row at temperature 0 is its
    argmax every time."""
    rng = _rng(6)
    n, Vs = 1 << 15, 24
    row = rng.normal(0, 1.5, Vs).astype(np.float32)
    temps = np.array([0.8, 1.2, 0.0], np.float32)
    top_k = np.array([0, 6, 0], np.int32)
    top_p = np.array([0.9, 1.0, 1.0], np.float32)
    min_p = np.array([0.02, 0.0, 0.0], np.float32)
    reps = lambda a: np.repeat(a, n)  # noqa: E731
    logits = np.tile(row, (3 * n, 1))
    keys = ts.fold(torch.tensor(ts.seed_key(3)), torch.arange(3 * n, dtype=torch.int64))
    per_row = {k: torch.from_numpy(reps(v)) for k, v in
               dict(temperature=temps, top_k=top_k, top_p=top_p, min_p=min_p).items()}
    ids = ts.sample_tokens(None, torch.from_numpy(logits), row_keys=keys, **per_row).numpy()
    for r in range(2):
        want = np.exp(np.asarray(js.proposal_log_probs(
            jnp.asarray(row), temperature=float(temps[r]), top_k=int(top_k[r]),
            top_p=float(top_p[r]), min_p=float(min_p[r]))))
        emp = np.bincount(ids[r * n:(r + 1) * n], minlength=Vs) / n
        assert 0.5 * np.abs(emp - want).sum() < 0.02, r
    assert (ids[2 * n:] == row.argmax()).all()


FAKE = dict(implementation="fake", base_model="fake", max_new_tokens=24, max_seq_len=256)


@pytest.mark.parametrize("pen", [dict(repetition_penalty=9.0, presence_penalty=0.4,
                                      frequency_penalty=0.2), dict(frequency_penalty=4.5)],
                         ids=["all three", "frequency"])
def test_spec_equals_baseline_and_jax_under_penalties(pen):
    """Greedy spec decoding (K=4, the fake draft that misses 15%: accept and
    reject paths both run) under static penalties gives the penalized
    baseline's ids, and JAX's engine's ids, proposed and accepted. The
    penalties are large enough to move ids off the fake model's +8 peak."""
    prompt = "qrs penalty check"
    base = Engine(EngineConfig(draft_model=None, **FAKE, **pen), device="cpu").generate(prompt)
    spec = Engine(EngineConfig(draft_model="fake", max_draft=4, **FAKE, **pen),
                  device="cpu").generate(prompt)
    want = JaxEngine(JaxEngineConfig(draft_model="fake", max_draft=4, **FAKE,
                                     **pen)).generate(prompt)
    plain = Engine(EngineConfig(draft_model=None, **FAKE), device="cpu").generate(prompt)
    assert spec["generated_ids"] == base["generated_ids"] == want["generated_ids"]
    assert (spec["proposed"], spec["accepted"]) == (want["proposed"], want["accepted"])
    assert 0.0 < spec["acceptance_rate"] < 1.0
    assert spec["generated_ids"] != plain["generated_ids"]  # the penalties bite
    np.testing.assert_allclose(spec["token_logprobs"], want["token_logprobs"], rtol=0, atol=1e-5)


def test_frequency_penalty_forbids_repeats():
    """A huge frequency penalty: no generated token repeats any token seen
    before it, prompt included (JAX's test_penalties case)."""
    ids = Engine(EngineConfig(draft_model=None, frequency_penalty=1e4, **FAKE),
                 device="cpu").generate("ab")["generated_ids"]
    assert len(ids) > 4 and len(set(ids)) == len(ids) and not set(ids) & {98, 99}


TINY = dict(base_model="llama-tiny", max_new_tokens=10, max_seq_len=256, dtype="float32",
            per_request_sampling=True, eos_token_id=-1)
PATHS = {"vanilla K=2": dict(draft_model="llama-tiny", max_draft=2),
         "ngram K=3": dict(draft_model=None, draft_mode="ngram", max_draft=3)}
LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged", kv_page_size=16)}
# (prompt, budget, controls): penalties and biases a request, one plain.
REQUESTS = [
    ("abcabcabc xyz abcabc", 10, {}),
    ("hello world hello", 10, dict(frequency_penalty=4.0, presence_penalty=2.0)),
    ("ab" * 8, 8, dict(repetition_penalty=3.0)),
    ("abc " * 5, 9, dict(logit_bias={66: 40.0, 98: -100.0}, presence_penalty=1.0)),
    ("the the the", 10, dict(frequency_penalty=8.0, logit_bias={5: 5.0})),
]


def _drive(b, requests, limit=200):
    rids = [b.submit(p, max_new_tokens=m, **kw) for p, m, kw in requests]
    b._admit_pending()
    for _ in range(limit):
        if not any(s is not None for s in b._slots) and not b.scheduler.pending():
            break
        b.step_chunk(1)
        b._retire_finished()
        b._admit_pending()
    return [b._done[rid].result for rid in rids]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("path", list(PATHS))
def test_batcher_per_request_penalties_and_bias_equal_jax(path, layout):
    """Five greedy requests through 2 slots, four with their own penalties
    or logit_bias: ids, proposed, accepted and finish reasons equal JAX's
    batcher's exactly, token logprobs (of the penalized distributions)
    within 1e-4; the plain request's ids are the engine's generate's; the
    controlled ones differ from their own plain run (the controls bite);
    a -100 bias bans its token and a +40 one is taken."""
    cfg = dict(TINY, **PATHS[path], **LAYOUTS[layout])
    want = _drive(jax_batcher(cfg, 2), REQUESTS)
    eng = port_engine(cfg)
    got = _drive(ContinuousBatcher(eng, n_slots=2), REQUESTS)
    for g, w in zip(got, want, strict=True):
        for key in ("generated_ids", "proposed", "accepted", "finish_reason"):
            assert g[key] == w[key], (key, g[key], w[key])
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"], rtol=0, atol=1e-4)
    plain = _drive(ContinuousBatcher(eng, n_slots=2), [(p, m, {}) for p, m, _ in REQUESTS])
    assert got[0]["generated_ids"] == plain[0]["generated_ids"] == eng.generate(
        REQUESTS[0][0])["generated_ids"][:REQUESTS[0][1]]
    for g, p in zip(got[1:], plain[1:]):
        assert g["generated_ids"] != p["generated_ids"]
    assert 98 not in got[3]["generated_ids"] and 66 in got[3]["generated_ids"]


def test_tree_refuses_penalties():
    """Static penalties in tree mode are refused at config time, a
    request's penalties at submit (the tree step has none); a bias and a
    plain request are taken."""
    tree = dict(implementation="fake", base_model="fake", draft_model=None, draft_mode="tree",
                max_seq_len=256)
    with pytest.raises(ValueError, match="tree"):
        EngineConfig(repetition_penalty=1.5, **tree).validate()
    b = ContinuousBatcher(Engine(EngineConfig(per_request_sampling=True, **tree), device="cpu"),
                          n_slots=2)
    for kw in (dict(frequency_penalty=0.5), dict(presence_penalty=1.0),
               dict(repetition_penalty=1.2)):
        with pytest.raises(ValueError, match="tree"):
            b.submit("x", **kw)
    b.submit("x", logit_bias={7: 100.0})
    b.submit("x", frequency_penalty=0.0)
    out = b.run()
    assert set(out[0]["generated_ids"]) == {7} and out[1]["generated_ids"]


def _same_tops(got, want, own_lp):
    """Top-N lists: ids exact, values within 1e-4 of JAX's; the first
    alternative is the committed greedy token, with its token logprob."""
    assert len(got) == len(want) == len(own_lp)
    for g, w, lp in zip(got, want, own_lp):
        assert [a["id"] for a in g] == [a["id"] for a in w]
        np.testing.assert_allclose([a["logprob"] for a in g], [a["logprob"] for a in w],
                                   rtol=0, atol=1e-4)
        assert g[0]["logprob"] == lp
        assert all(x["logprob"] >= y["logprob"] for x, y in zip(g, g[1:]))


@pytest.mark.parametrize("mode", ["baseline", "vanilla K=2", "tree"])
def test_top_logprobs_generate_and_batcher_equal_jax(mode):
    """logprobs_topk=4 on llama-tiny f32: generate (B=2) and the batcher
    (3 requests, 2 slots) give JAX's top-4 ids at every generated position
    and values within 1e-4; the first is the committed token."""
    kw = {"baseline": dict(draft_model=None), "vanilla K=2": dict(draft_model="llama-tiny",
                                                                 max_draft=2),
          "tree": dict(draft_model=None, draft_mode="tree", medusa={"head_init": "copy"})}[mode]
    cfg = dict(TINY, per_request_sampling=False, logprobs_topk=4, **kw)
    prompts = ["abcabcabc xyz abcabc", "hello world"]
    jb = jax_batcher(cfg, 2)
    eng = port_engine(cfg)
    if mode == "tree":
        from llm_inference_lab_tpu_torch.convert import params_from_jax

        eng = Engine(EngineConfig(**cfg), device="cpu", target_params=eng.target.params,
                     draft_params=params_from_jax(jb.engine._draft_params))
    got, want = eng.generate_batch(prompts), jb.engine.generate_batch(prompts)
    for g, w in zip(got, want, strict=True):
        assert g["generated_ids"] == w["generated_ids"]
        _same_tops(g["top_logprobs"], w["top_logprobs"], g["token_logprobs"])
    reqs = [(p, 8, {}) for p in prompts + ["ab" * 6]]
    got, want = _drive(ContinuousBatcher(eng, n_slots=2), reqs), _drive(jb, reqs)
    for g, w in zip(got, want, strict=True):
        assert g["generated_ids"] == w["generated_ids"]
        _same_tops(g["top_logprobs"], w["top_logprobs"], g["token_logprobs"])
    off = port_engine(dict(cfg, logprobs_topk=0, draft_model=None, draft_mode="vanilla"))
    assert off.generate("x")["top_logprobs"] is None


@pytest.mark.parametrize("mode", ["vanilla K=2", "ngram K=3", "tree [3, 2]"])
def test_plain_step_serves_greedy_rows_exactly(mode):
    """Under per-request sampling a chunk whose requests are all greedy with
    no penalty or bias replays the plain greedy step (Engine._plain): the
    same ids, logprobs and top-3 lists as the per-request step (an engine
    with the plain step taken away), on a greedy-only run (every step
    plain), a mixed run (sampled, penalized and biased requests beside
    greedy ones: some steps plain, some not) and generate."""
    kw = {"vanilla K=2": dict(draft_model="fake", max_draft=2),
          "ngram K=3": dict(draft_model=None, draft_mode="ngram", max_draft=3),
          "tree [3, 2]": dict(draft_model=None, draft_mode="tree")}[mode]
    cfg = dict(FAKE, per_request_sampling=True, logprobs_topk=3, **kw)
    eng, forced = (Engine(EngineConfig(**cfg), device="cpu") for _ in range(2))
    forced._plain = None
    assert eng._plain is not None
    pen = {} if mode.startswith("tree") else dict(frequency_penalty=3.0)
    runs = {"greedy": [(f"greedy {i}", 6 + 3 * i, {}) for i in range(4)],
            "mixed": [("plain one", 20, {}), ("hot", 6, dict(temperature=2.0, seed=3)),
                      ("plain two", 18, {}), ("biased", 5, dict(logit_bias={9: 50.0})),
                      ("penalized", 4, pen)]}
    for what, reqs in runs.items():
        b, fb = ContinuousBatcher(eng, n_slots=2), ContinuousBatcher(forced, n_slots=2)
        got, want = _drive(b, reqs), _drive(fb, reqs)
        for g, w in zip(got, want, strict=True):
            for key in ("generated_ids", "token_logprobs", "top_logprobs", "proposed",
                        "accepted"):
                assert g[key] == w[key], (what, key)
        assert fb.stats.plain_steps == 0
        if what == "greedy":
            assert b.stats.plain_steps == b.stats.steps > 0
        else:
            assert 0 < b.stats.plain_steps < b.stats.steps
    for key in ("generated_ids", "token_logprobs", "top_logprobs"):
        assert eng.generate("gen check")[key] == forced.generate("gen check")[key]
