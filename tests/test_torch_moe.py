"""Port parity for the MoE block (ops/moe.py) against the JAX package's
moe_ragged (its engine's default) and moe_dense on the CPU: the routing,
a tied router row, and the expert MLP; then Mixtral's decode loop (on the
CPU its in-place step, which the card captures and replays) against the
host loop's functional step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops import moe as jmoe
from llm_inference_lab_tpu_torch.config import EngineConfig, EnvFlags
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.ops import moe
from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_families import PROMPT, _jax_params


def _inputs(seed, T=9, D=32, F=48, E=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (T, D)).astype(np.float32),
            rng.normal(0, 1, (D, E)).astype(np.float32),
            rng.normal(0, 0.2, (E, D, 2 * F)).astype(np.float32),
            rng.normal(0, 0.2, (E, F, D)).astype(np.float32))


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_matches_ragged_and_dense(act, top_k):
    """f32: the port's block within 1e-5 of the largest output of both JAX
    implementations (the same products, summed in other orders), and its
    routing (experts exactly, weights within 1e-6) equal to JAX's _route."""
    arrays = _inputs(top_k)
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    got = moe.moe_mlp(*tx, top_k=top_k, act=act).numpy()
    for fn in (jmoe.moe_ragged, jmoe.moe_dense):
        ref = np.asarray(fn(*jx, top_k=top_k, act=act))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    jw, je = jmoe._route(jx[0], jx[1], top_k)
    tw, te = moe.route(tx[0], tx[1], top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def test_tied_router_rows_route_as_lax_top_k():
    """Rows whose router logits tie: experts 1 and 3 share a column (every
    row ties them), and row 0 ties all four (x = 0): lax.top_k takes the
    lower index first, and so does the port, down to the output."""
    x, w_router, gu, dn = _inputs(5)
    w_router[:, 3] = w_router[:, 1]
    x[0] = 0.0
    jx = [jnp.asarray(a) for a in (x, w_router, gu, dn)]
    tx = [torch.from_numpy(a) for a in (x, w_router, gu, dn)]
    for k in (1, 2, 3):
        _, je = jmoe._route(jx[0], jx[1], k)
        _, te = moe.route(tx[0], tx[1], k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        assert te[0].tolist() == list(range(k))
        ref = np.asarray(jmoe.moe_ragged(*jx, top_k=k))
        got = moe.moe_mlp(*tx, top_k=k).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_moe_in_bf16_rounds_as_documented():
    """bf16 inputs: the port's block rounds the gate-up product and the
    expert rows to bf16 and sums the experts in f32; within 2^-6 of the
    largest output of the f32 block (both JAX versions round in between at
    other places)."""
    arrays = _inputs(7)
    tx = [torch.from_numpy(a) for a in arrays]
    ref = moe.moe_mlp(*tx).numpy()
    got = moe.moe_mlp(*(t.bfloat16() for t in tx)).float().numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -6 * np.abs(ref).max()


def test_mixtral_decode_loop_equals_host_step(one_thread):  # noqa: F811
    """mixtral-tiny (f32) with ngram K=3 and its baseline: the decode loop
    (its in-place step, what a CUDA graph replays on the card) gives the
    host loop's ids, counts and logprobs bit for bit."""
    params = params_from_jax(_jax_params("mixtral-tiny", 3))
    for kw in (dict(draft_mode="ngram", max_draft=3), dict()):
        cfg = EngineConfig(base_model="mixtral-tiny", draft_model=None, max_seq_len=256,
                           max_new_tokens=16, dtype="float32", **kw)
        loop = Engine(cfg, device="cpu", target_params=params).generate(PROMPT)
        host = Engine(cfg, device="cpu", target_params=params,
                      flags=EnvFlags(sync_steps=True)).generate(PROMPT)
        for key in ("generated_ids", "accepted", "proposed", "steps", "token_logprobs"):
            assert loop[key] == host[key], key
