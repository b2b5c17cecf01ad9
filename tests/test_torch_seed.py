"""Per-request seeds (core/batching.py derive_request_seed and the slots'
keys, DecodeState.slot_rng; port of tests/test_seed.py).

A row draws from its slot's key folded with its committed length and the
sampling site, so a request's sampled ids depend on its seed, prompt and
parameters only: not on the requests beside it, its slot, or a preemption
that sends it back to the queue to resume by recompute. The port's random
numbers are not JAX's, so where JAX's tests compare ids the draws here are
held to their distributions: total variation < 0.02 against the softmax
of JAX's per-row filtered (and penalized) logits, JAX's bound for its own
sampler.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops import sampling as js
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher, derive_request_seed
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.specstep import make_baseline_step
from llm_inference_lab_tpu_torch.core.state import init_state
from llm_inference_lab_tpu_torch.models.fake import make_fake_model
from llm_inference_lab_tpu_torch.ops.sampling import fold, seed_key
from test_torch_lazy_pages import LAZY, one_thread, port_engine  # noqa: F401

FAKE = dict(implementation="fake", base_model="fake", draft_model="fake", max_draft=3,
            max_new_tokens=16, max_seq_len=256, per_request_sampling=True)
HOT = dict(temperature=3.0)  # diverse draws on the fake model's peaked logits


def _engine(**kw):
    return Engine(EngineConfig(**dict(FAKE, **kw)), device="cpu")


def _run(b, requests):
    """Submit (prompt, controls) pairs and run; the ids by submission."""
    rids = [b.submit(p, **kw) for p, kw in requests]
    out = {r["req_id"]: r for r in b.run()}
    return [out[rid]["generated_ids"] for rid in rids]


def test_derive_request_seed_is_jax_s():
    """The same seeds as JAX's derive_request_seed: an explicit seed
    clamped to 31 bits, else one from the engine's seed and the id."""
    from llm_inference_lab_tpu.core.batching import derive_request_seed as jax_derive

    for args in ((0, 0, None), (3, 17, None), (5, 9, 1234), (1, 2, -7), (7, 1, 2 ** 40 + 3)):
        assert derive_request_seed(*args) == jax_derive(*args)


@pytest.mark.parametrize("mode", ["vanilla K=3", "baseline", "ngram K=3", "medusa K=2",
                                  "tree [2, 2]"])
def test_seed_reproducible_across_batch_compositions(mode):
    """The same seed and prompt give the same ids alone and among other
    sampled requests (another slot, other neighbours), on every drafting
    mode's step; a seeded request differs from the greedy run."""
    kw = {"vanilla K=3": {}, "baseline": dict(draft_model=None),
          "ngram K=3": dict(draft_model=None, draft_mode="ngram"),
          "medusa K=2": dict(draft_model=None, draft_mode="medusa", max_draft=2),
          "tree [2, 2]": dict(draft_model=None, draft_mode="tree",
                              tree={"branching": [2, 2]})}[mode]
    eng = _engine(**kw)
    seeded = ("seeded prompt", dict(seed=1234, **HOT))
    (alone,) = _run(ContinuousBatcher(eng, n_slots=4), [seeded])
    with_traffic = _run(ContinuousBatcher(eng, n_slots=4), [
        ("some other request padding the batch", HOT), seeded,
        ("yet another neighbour", dict(temperature=2.0)), ("and a greedy one", {})])
    assert alone == with_traffic[1]
    (greedy,) = _run(ContinuousBatcher(eng, n_slots=4), [("seeded prompt", {})])
    assert alone != greedy


def test_seeds_differ_and_repeat_in_any_slot():
    """Different seeds give different ids; the same seed the same ids, in
    whichever slot the request lands."""
    eng = _engine()
    a, b, c = _run(ContinuousBatcher(eng, n_slots=4), [
        ("p", dict(seed=7, **HOT)), ("p", dict(seed=8, **HOT)), ("p", dict(seed=7, **HOT))])
    assert a == c and a != b


def test_unseeded_requests_are_deterministic_per_engine_seed():
    """No seed: the key derives from the engine's seed and the request id,
    so a serving trace replays; another engine seed draws otherwise."""
    reqs = [("replay me", HOT), ("and me", HOT)]
    first = _run(ContinuousBatcher(_engine(), n_slots=2), reqs)
    assert first == _run(ContinuousBatcher(_engine(), n_slots=2), reqs)
    assert first != _run(ContinuousBatcher(_engine(seed=5), n_slots=2), reqs)


def test_seed_composes_with_penalties_and_bias():
    """Seeded streams with penalties and a ban stay batch-composition
    independent, and the banned token never appears."""
    kw = dict(seed=42, temperature=3.0, presence_penalty=0.4, frequency_penalty=0.2,
              logit_bias={5: -100.0})
    (one,) = _run(ContinuousBatcher(_engine(), n_slots=2), [("rep", kw)])
    two = _run(ContinuousBatcher(_engine(), n_slots=2), [("noise neighbour", HOT), ("rep", kw)])
    assert one == two[1] and 5 not in one


def test_seeded_request_resumes_with_the_draws_it_would_have_made():
    """llama-tiny over a paged pool too small for both requests' growth:
    the younger seeded request is preempted and resumes by recompute, and
    both requests' ids (sampled at temperature 20, far from greedy on the
    x10 weights) and top-3 ids equal a run whose pool never preempts; the
    resumed request's top-N list covers every generated position."""
    cfg = dict(LAZY, per_request_sampling=True, logprobs_topk=3)
    reqs = [("preempt victim check", dict(max_new_tokens=48, seed=11, temperature=20.0)),
            ("preempt survivor check", dict(max_new_tokens=48, seed=12, temperature=20.0))]
    runs = {}
    for pages in (8, None):
        b = ContinuousBatcher(port_engine(dict(cfg, kv_pages=pages)), n_slots=2)
        rids = [b.submit(p, **kw) for p, kw in reqs]
        out = {r["req_id"]: r for r in b.run()}
        runs[pages] = (b, [out[rid] for rid in rids])
    b, got = runs[8]
    _, want = runs[None]
    assert b.stats.preemptions >= 1 and any(r.resume_ids is not None for r in b._done.values())
    assert runs[None][0].stats.preemptions == 0
    greedy = port_engine(dict(cfg, kv_pages=None)).generate(reqs[0][0])["generated_ids"]
    assert got[0]["generated_ids"][:48] != greedy[:48]
    for g, w in zip(got, want):
        assert g["generated_ids"] == w["generated_ids"]
        assert len(g["top_logprobs"]) == len(g["generated_ids"])
        assert [[a["id"] for a in p] for p in g["top_logprobs"]] == [
            [a["id"] for a in p] for p in w["top_logprobs"]]
        np.testing.assert_allclose([a["logprob"] for p in g["top_logprobs"] for a in p],
                                   [a["logprob"] for p in w["top_logprobs"] for a in p],
                                   rtol=0, atol=1e-4)


def test_generate_under_per_request_sampling_repeats_by_seed():
    """Engine.generate with per_request_sampling (each row's key from the
    call's seed): a seed repeats its ids, another seed differs."""
    eng = _engine(greedy=False, temperature=3.0)
    a, b = (eng.generate("hot", seed=s)["generated_ids"] for s in (1, 1))
    assert a == b and a != eng.generate("hot", seed=2)["generated_ids"]


def test_step_draws_follow_the_per_row_filtered_penalized_softmax():
    """One per-request baseline step over 2**15 lanes of one prompt on the
    fake model, each lane its own key, two groups of rows with their own
    temperature, top_k, top_p, min_p and presence penalty: each group's
    first tokens are within total variation 0.02 of exp(log_softmax) of
    JAX's filtered_logits (dynamic path) over JAX's apply_penalties of the
    same logits."""
    model = make_fake_model()
    n, V, L = 1 << 15, 256, 12
    state = init_state(model, None, 2 * n, 64, "cpu")
    prompt = torch.tensor([5, 9, 17, 5, 40, 9, 33, 5, 2, 71, 9, 18], dtype=torch.int32)
    state.tokens[:, :L] = prompt
    state.lengths.fill_(L)
    state.prompt_lens.fill_(L)
    state.active.fill_(True)
    groups = [dict(temperature=6.0, top_k=20, top_p=0.9, min_p=0.0, presence_penalty=0.0),
              dict(temperature=8.0, top_k=0, top_p=0.1, min_p=0.3, presence_penalty=0.7)]
    for g, params in enumerate(groups):
        for name, value in params.items():
            getattr(state, name)[g * n:(g + 1) * n] = value
    state.slot_rng.copy_(fold(seed_key(9), torch.arange(2 * n, dtype=torch.int64)))
    with torch.inference_mode():
        out = make_baseline_step(model, per_request_sampling=True)(state)
        logits, _ = model.forward(prompt[None, -1:], torch.tensor([[L - 1]]), None,
                                  torch.tensor([L - 1]))
    drawn = out.tokens[:, L].numpy()
    counts = np.bincount(prompt.numpy(), minlength=V)[None]
    for g, params in enumerate(groups):
        pen = js.apply_penalties(jnp.asarray(logits[:, 0].numpy()), jnp.asarray(counts),
                                 presence=params["presence_penalty"])
        filt = js.filtered_logits(pen, **{k: jnp.asarray([params[k]])
                                          for k in ("temperature", "top_k", "top_p", "min_p")})
        want = np.exp(np.asarray(filt - jnp.max(filt)))[0]
        want /= want.sum()
        emp = np.bincount(drawn[g * n:(g + 1) * n], minlength=V) / n
        assert 0.5 * np.abs(emp - want).sum() < 0.02, g
        assert (want > 0.01).sum() >= 5  # a spread distribution, not a point mass
