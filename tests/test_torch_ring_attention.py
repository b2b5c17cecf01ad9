"""Port parity for the seq mesh axis (parallel/context.py, the shard variant
of kernels D and E, Engine under seq) against the JAX package on the CPU.

ring_self_attention on 2 and 4 gloo ranks (tests/torch_parallel_ranks.py,
one thread each) against JAX's ring_self_attention on its virtual CPU
devices (JAX's own cases: MHA, GQA, ragged lengths; f32 within 1e-5); the
shard variant's plain version (ops/flash_decode.py flash_decode_shard_plain,
which flash_prefill_shard also runs on the CPU) over 2 and 4 slices of a
cache, merged by log-sum-exp (merge_shards), against the plain versions of
D and E over the whole cache (f32 within 1e-5; bf16 and int8 within the
Gemma tests' 2^-7 |ref| + 2^-7: the slices round their probabilities
against their own maxima); Engine ids under seq = 2 against JAX's
Engine(mesh_shape={"seq": 2}), with a bf16 and an int8 KV cache; and JAX's
refusals under the seq axis, message for message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.parallel.context import ring_self_attention as jax_ring
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.models.base import quantize_rows
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    flash_decode_plain,
    flash_decode_shard,
    flash_decode_shard_plain,
    merge_shards,
)
from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_shard
from llm_inference_lab_tpu_torch.parallel.mesh import AXES, Mesh
from llm_inference_lab_tpu_torch.parallel.context import ring_self_attention
from llm_inference_lab_tpu_torch.parallel.multihost import launch

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_parallel import jax_model, port_config, tp_config

pytestmark = pytest.mark.usefixtures("one_thread")


def _mk(B, S, H, n_kv, D, seed=0):
    """JAX's tests/test_ring_attention.py inputs."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(ks[0], (B, S, H, D), jnp.float32),
            jax.random.normal(ks[1], (B, S, n_kv, D), jnp.float32),
            jax.random.normal(ks[2], (B, S, n_kv, D), jnp.float32))


# JAX's cases (tests/test_ring_attention.py): MHA, GQA, ragged lengths.
RING_CASES = {"mha": ((2, 64, 4, 4, 16), 0, None),
              "gqa": ((2, 64, 8, 2, 16), 1, None),
              "ragged": ((3, 64, 4, 2, 16), 2, [64, 37, 5])}


@pytest.fixture(scope="module")
def ring_runs():
    """Each case's inputs, JAX's ring output on n virtual devices and the
    port's on n gloo ranks, for n = 2 and 4 (one launch a world size)."""
    cases = {}
    for name, (shape, seed, lengths) in RING_CASES.items():
        q, k, v = _mk(*shape, seed=seed)
        lens = None if lengths is None else np.asarray(lengths, np.int32)
        cases[name] = tuple(np.asarray(a) for a in (q, k, v)) + (lens,)
    out = {}
    for n in (2, 4):
        mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
        want = {name: np.asarray(jax_ring(*(jnp.asarray(a) for a in c[:3]), mesh,
                                          lengths=None if c[3] is None else jnp.asarray(c[3])))
                for name, c in cases.items()}
        got = launch(ranks.ring_attention, n, args=(cases, n), threads=1, timeout=300)
        out[n] = (want, got)
    return out


@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_equals_jax(ring_runs, n, case):
    want, got = ring_runs[n]
    for r in range(n):
        assert np.array_equal(got[r][case], got[0][case]), ("rank", r)
        np.testing.assert_allclose(got[r][case], want[case], rtol=1e-5, atol=1e-5)


def test_ring_self_attention_refuses_a_split_that_does_not_divide():
    """JAX's ValueError, word for word, before any collective."""
    q, k, v = _mk(1, 30, 2, 2, 16)
    with pytest.raises(ValueError) as jerr:
        jax_ring(q, k, v, JaxMesh(np.array(jax.devices()[:4]), ("seq",)))
    mesh = Mesh({"data": 1, "seq": 4, "model": 1}, 0, {a: 0 for a in AXES}, "gloo")
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v)]
    with pytest.raises(ValueError) as perr:
        ring_self_attention(*t, mesh)
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------- the shard variant, plainly
def _cache(kind, B, KVH, T, D, seed):
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn((B, KVH, T, D), generator=g) for _ in range(2))
    if kind == "f32":
        return k, v, None, None
    if kind == "bf16":
        return k.bfloat16(), v.bfloat16(), None, None
    (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    return k, v, ks, vs


@pytest.mark.parametrize("S", [1, 5, 40])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_slices_merge_to_the_whole_cache(n, kind, S):
    """n slices of a T = 256 cache (two sequences at positions 100.. and
    230.., so some slices lie wholly after a row and give zeros and -inf),
    each through the shard variant's plain version at its t0, merged: the
    whole cache's rows through D's (S <= 32) or E's (S > 32) plain version,
    and the merged lse the log-sum-exp of the row's scores over the whole
    cache. flash_decode_shard and flash_prefill_shard run the same plain
    version on the CPU."""
    B, H, KVH, T, D = 2, 8, 2, 256, 32
    k, v, ks, vs = _cache(kind, B, KVH, T, D, seed=n * 10 + S)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator().manual_seed(S)
    q = torch.randn((B, S, H, D), generator=g).to(dtype)
    pos = (torch.tensor([[100], [230]]) + torch.arange(S)).int()
    whole = (flash_decode_plain if S <= 32 else flash_prefill)(q, k, v, pos, ks, vs).float()
    per = T // n
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        sc = (ks[:, :, sl], vs[:, :, sl]) if ks is not None else (None, None)
        o, l = flash_decode_shard_plain(q, k[:, :, sl], v[:, :, sl], pos, r * per, *sc)
        assert o.dtype == torch.float32 and l.shape == (B, H, S)
        dead = ~torch.isfinite(l)
        assert torch.all(o[dead.transpose(1, 2)] == 0)
        wrap = flash_decode_shard if ks is not None or S <= 32 else flash_prefill_shard
        got = wrap(q, k[:, :, sl], v[:, :, sl], pos, r * per, *sc) if wrap is flash_decode_shard \
            else wrap(q, k[:, :, sl], v[:, :, sl], pos, r * per)
        assert torch.equal(got[0], o) and torch.equal(got[1], l)
        outs.append(o)
        lses.append(l)
    out, lse = merge_shards(torch.stack(outs), torch.stack(lses))
    tol = 1e-5 if kind == "f32" else 2.0 ** -7 * whole.abs() + 2.0 ** -7
    assert torch.all((out - whole).abs() <= tol)
    # The scores as the plain versions take them: an int8 cache dequantized
    # to q's dtype (attend_xla's rounding).
    kf = (k.float() * ks[..., None]).to(dtype).float() if ks is not None else k.float()
    qg = q.float().reshape(B, S, KVH, H // KVH, D)
    scores = torch.einsum("bsngd,bntd->bngst", qg, kf) * D ** -0.5
    later = torch.arange(T)[None, None, None, None] > pos[:, None, None, :, None]
    scores = scores.masked_fill(later, float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).reshape(B, H, S).numpy(),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- the engine
def test_engine_under_seq_equals_jax():
    """Engine.generate_batch on 2 seq ranks (ring prefill of both models,
    T-split caches, the slices merged at every decode forward) against
    JAX's Engine(mesh_shape={"seq": 2}) on the same weights, vanilla K=2
    with a draft, a bf16 and an int8 KV cache: equal ids (JAX's ring and the
    cache's GSPMD split give its unsharded ids, tests/test_long_context.py)."""
    tkw, dkw = tp_config(2, 2, "cp-target"), tp_config(2, 1, "cp-draft")
    target, draft = jax_model(tkw, seed=11), jax_model(dkw, seed=12)
    prompts = ["a ring prompt of some length for the seq axis", "the second one"]
    kws = [dict(max_draft=2, max_new_tokens=10, dtype="float32"),
           dict(max_draft=2, max_new_tokens=10, dtype="float32", kv_quantization="int8")]
    want = []
    for kw in kws:
        jeng = JaxEngine(JaxEngineConfig(implementation="hf", mesh_shape={"seq": 2}, **kw),
                         target_model=target, draft_model=draft)
        want.append([r["generated_ids"] for r in jeng.generate_batch(prompts)])
    configs = {"cp-target": port_config(tkw), "cp-draft": port_config(dkw)}
    port_kws = [dict(kw, base_model="cp-target", draft_model="cp-draft") for kw in kws]
    got = launch(ranks.mesh_engine_ids, 2,
                 args=(configs, port_kws, params_from_jax(target.params),
                       params_from_jax(draft.params), prompts, {"seq": 2}),
                 threads=1, timeout=300)
    for r in range(2):
        assert got[r] == want, ("rank", r)


def _seq_mesh():
    """Rank 0's view of a seq = 2 mesh without a process group: each refusal
    raises before a collective would run."""
    return Mesh({"data": 1, "seq": 2, "model": 1}, 0, {a: 0 for a in AXES}, "gloo")


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    raise AssertionError("no refusal")


TINY = dict(draft_model=None, max_new_tokens=4, dtype="float32", max_seq_len=96)
SEQ_REFUSALS = {
    # JAX engine.py:174-179; kv_ring needs a prefill_chunk in the port's
    # config, so it meets the same refusal (JAX checks prefill_chunk first).
    "prefill_chunk": dict(base_model="llama-tiny", prefill_chunk=32),
    "kv_ring": dict(base_model="mistral-tiny", prefill_chunk=32, kv_ring=True,
                    max_seq_len=512),
    # JAX transformer.py:343-360, raised by the ring prefill's forward.
    "gemma2": dict(base_model="gemma2-tiny"),
    "window": dict(base_model="mistral-tiny"),
}


@pytest.mark.parametrize("what", sorted(SEQ_REFUSALS))
def test_seq_refusals_keep_jax_messages(what):
    kw = dict(TINY, **SEQ_REFUSALS[what])

    def jax_run():
        JaxEngine(JaxEngineConfig(implementation="hf", mesh_shape={"seq": 2}, **kw)).generate(
            "seq axis refusal")

    def port_run():
        Engine(EngineConfig(**kw), device="cpu", mesh=_seq_mesh()).generate("seq axis refusal")

    assert _message(port_run) == _message(jax_run)
