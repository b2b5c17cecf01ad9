"""Port parity for the expert mesh axis and MoE under a mesh (ops/moe.py
moe_expert, the expert stacks' sharding, Engine under expert) against the
JAX package on the CPU.

moe_expert on gloo ranks (tests/torch_parallel_ranks.py, one thread each)
at expert 2 and 4, at model 2 (each rank its F / 2 gate and up columns and
w_down rows) and at expert 2 x model 2, against JAX's moe_dense over the
whole stacks (f32 within 1e-5: the ranks' partials, f32 throughout, add in
another order); shard_params' expert slices (dim 1 of the [L, E, ...]
stacks) against numpy's slices of the JAX arrays at expert 2 and 4 and
unshard_params' rebuild, and the sharding rule on every mixtral-tiny leaf
against JAX's _spec_for with the stage and expert flags; Engine ids of a
mixtral-tiny at expert 2 (greedy, and ngram drafting) and model 2 against
JAX's Engine(mesh_shape={"expert": 2}) and its unsharded engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.mixtral import MIXTRAL_CONFIGS as JAX_MIXTRAL
from llm_inference_lab_tpu.models.mixtral import MixtralModel
from llm_inference_lab_tpu.ops.moe import moe_dense
from llm_inference_lab_tpu.parallel.sharding import _spec_for as jax_spec_for
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.models.mixtral import MIXTRAL_CONFIGS
from llm_inference_lab_tpu_torch.parallel.mesh import AXES, Mesh
from llm_inference_lab_tpu_torch.parallel.multihost import launch
from llm_inference_lab_tpu_torch.parallel.sharding import _spec_for, shard_params, unshard_params

import torch_parallel_ranks as ranks
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_parallel import flat, port_arrays

pytestmark = pytest.mark.usefixtures("one_thread")

T_ROWS, D, E, F, TOP_K = 6, 32, 8, 24, 2


@pytest.fixture(scope="module")
def moe_case():
    g = np.random.default_rng(21)
    x = g.normal(0, 1, (T_ROWS, D)).astype(np.float32)
    router = g.normal(0, 0.5, (D, E)).astype(np.float32)
    gate_up = g.normal(0, 0.1, (E, D, 2 * F)).astype(np.float32)
    down = g.normal(0, 0.1, (E, F, D)).astype(np.float32)
    want = np.asarray(moe_dense(*(jnp.asarray(a) for a in (x, router, gate_up, down)),
                                top_k=TOP_K))
    return (x, router, gate_up, down), want


@pytest.mark.parametrize("shape", [{"expert": 2}, {"expert": 4}, {"model": 2},
                                   {"expert": 2, "model": 2}], ids=lambda s: "x".join(
                                       f"{k}{v}" for k, v in s.items()))
def test_moe_expert_equals_jax_moe_dense(moe_case, shape):
    (x, router, gate_up, down), want = moe_case
    n = int(np.prod(list(shape.values())))
    got = launch(ranks.expert_moe, n, args=(x, router, gate_up, down, TOP_K, shape), threads=1,
                 timeout=300)
    for r in range(n):
        assert np.array_equal(got[r], got[0]), ("rank", r)
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)


def test_spec_for_equals_jax_on_every_mixtral_leaf():
    cfg = dataclasses.replace(JAX_MIXTRAL["mixtral-tiny"], dtype=jnp.float32)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert any("w_router" in jax.tree_util.keystr(p) for p, _ in leaves)
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        for stage in (False, True):
            for expert in (False, True):
                want = tuple(jax_spec_for(name, leaf.ndim, stage, expert))
                assert _spec_for(name, leaf.ndim, stage, expert) == want, (name, stage, expert)


def _expert_mesh(n: int, e: int) -> Mesh:
    return Mesh({"data": 1, "expert": n, "model": 1}, e,
                {a: (e if a == "expert" else 0) for a in AXES}, "gloo")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_takes_each_ranks_experts(n):
    """Expert rank e holds experts [e E/n, (e+1) E/n) of w_gate_up [L, E, D,
    2F] and w_down [L, E, F, D] (numpy's slices of the JAX arrays), the
    router and every other leaf whole; the ranks' trees rebuild the full
    tree byte for byte."""
    cfg = dataclasses.replace(JAX_MIXTRAL["mixtral-tiny"], dtype=jnp.float32)
    jparams = jt.init_params(cfg, jax.random.PRNGKey(1))
    full = params_from_jax(jparams)
    pcfg = dataclasses.replace(MIXTRAL_CONFIGS["mixtral-tiny"], dtype=torch.float32)
    parts = [shard_params(full, _expert_mesh(n, e), pcfg) for e in range(n)]
    jleaves = dict(flat(jparams))
    for e, part in enumerate(parts):
        for key, leaf in flat(part):
            want = np.asarray(jleaves[key])
            if key[-1] in ("w_gate_up", "w_down"):
                En = want.shape[1]
                want = want[:, e * En // n:(e + 1) * En // n]
            np.testing.assert_array_equal(port_arrays(leaf)[0].numpy(), want,
                                          err_msg=f"{key} expert {e}")
    rebuilt = dict(flat(unshard_params(parts, pcfg, {"expert": n})))
    for key, leaf in flat(full):
        assert torch.equal(rebuilt[key], leaf), key


def _mixtral():
    """JAX's tests/test_moe.py target: mixtral-tiny from PRNGKey(11), f32."""
    return MixtralModel.create("mixtral-tiny", rng=jax.random.PRNGKey(11), dtype=jnp.float32)


ENGINE_KW = dict(base_model="mixtral-tiny", draft_model=None, greedy=True, max_new_tokens=10,
                 max_seq_len=128, dtype="float32")
ENGINES = {"greedy": ({}, "expert parallel engine check"),
           "ngram": (dict(draft_mode="ngram", max_draft=3), "the cat sat. the cat sat. the")}


def test_engine_under_expert_and_model_equals_jax():
    """JAX's test_expert_parallel_engine at expert 2: Engine ids (greedy and
    ngram drafting) equal JAX's Engine(mesh_shape={"expert": 2}) and its
    unsharded engine on the same weights; and at model 2 (F split over the
    ranks) the unsharded JAX engine's ids."""
    params = params_from_jax(_mixtral().params)
    want = {}
    for name, (extra, prompt) in ENGINES.items():
        ids = [JaxEngine(JaxEngineConfig(implementation="hf", mesh_shape=shape, **ENGINE_KW,
                                         **extra), target_model=_mixtral()).generate(prompt)
               ["generated_ids"] for shape in ({"expert": 2}, {})]
        assert ids[0] == ids[1], name
        want[name] = ids[0]
    pairs = [(dict(ENGINE_KW, **extra), prompt) for extra, prompt in ENGINES.values()]
    for shape in ({"expert": 2}, {"model": 2}):
        got = launch(ranks.engine_prompts, 2, args=({}, pairs, params, shape), threads=1,
                     timeout=300)
        for r in range(2):
            assert got[r] == [want[k] for k in ENGINES], (shape, "rank", r)


def test_batcher_under_expert_equals_one_process():
    """A ContinuousBatcher (2 slots, 3 requests: one waits for a slot) of the
    mixtral-tiny on 2 expert ranks gives the one-process batcher's ids on
    every rank (the ranks take the same host decisions from the same
    inputs; each MoE layer sums its experts over the axis)."""
    params = params_from_jax(_mixtral().params)
    prompts = ["expert batcher one", "the cat sat. the cat sat. the", "a third request"]
    kw = dict(ENGINE_KW, draft_mode="ngram", max_draft=3)
    want = ranks.batcher_ids({}, kw, params, prompts, {})
    got = launch(ranks.batcher_ids, 2, args=({}, kw, params, prompts, {"expert": 2}),
                 threads=1, timeout=300)
    for r in range(2):
        assert got[r] == want, ("rank", r)
