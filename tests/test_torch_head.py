"""The tied head's logits in f32, against the JAX package's.

JAX computes the tied head (bf16 table or the int8 EmbedQuant) with
preferred_element_type=f32: f32 products, f32 sums, f32 logits, then for
int8 the row scales in f32. The port must not round its logits to bf16 on
the way: a bf16 rounding leaves ~2,000 distinct values in a row of 32,000
logits, and greedy decoding then sees ties that the reference does not have.

Both packages' own functions on the same inputs, made with numpy from a
seed: bf16 x [4, 1024], a table of V = 32,000 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.models import transformer as jt
from llm_inference_lab_tpu.models.base import ModelConfig as JaxModelConfig
from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.models import transformer as tt
from llm_inference_lab_tpu_torch.models.base import ModelConfig

V, D, ROWS = 32000, 1024, 4


def _inputs(table_kind):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (ROWS, D)).astype(np.float32)
    table = rng.normal(0, 0.02, (V, D)).astype(np.float32)
    kw = dict(vocab_size=V, n_layers=1, n_heads=8, n_kv_heads=8, d_model=D, d_ff=2 * D,
              tie_word_embeddings=True)
    jcfg = JaxModelConfig(name="head", arch="llama", dtype=jnp.bfloat16, **kw)
    tcfg = ModelConfig(name="head", dtype=torch.bfloat16, **kw)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    embed = (jq.quantize_embed(jnp.asarray(table)) if table_kind == "int8"
             else jnp.asarray(table).astype(jnp.bfloat16))
    jparams = {"embed": embed}
    return jcfg, tcfg, jparams, params_from_jax(jparams), jx, tx


@pytest.mark.parametrize("table_kind", ["bf16", "int8"])
def test_tied_head_logits_are_f32_as_jax(table_kind):
    """The port's logits equal JAX's within the f32 summation order: per
    element, D * 2^-24 * sum_i |x_i w_i| (a sum of D terms in any order),
    times the row scale for int8. A bf16 rounding of the logits (2^-9 of
    each) is far outside that. The count of distinct logits a row is within
    1% of JAX's."""
    jcfg, tcfg, jparams, tparams, jx, tx = _inputs(table_kind)
    ref = np.asarray(jt.lm_head_logits(jcfg, jparams, jx), np.float32)
    got = tt.lm_head_logits(tcfg, tparams, tx)
    assert got.dtype == torch.float32 and got.shape == (ROWS, V)
    got = got.numpy()
    embed = tparams["embed"]
    if table_kind == "int8":
        w, scale = embed.q.float(), embed.scale.numpy()
    else:
        w, scale = embed.float(), np.ones(V, np.float32)
    abs_sum = (tx.float().abs() @ w.abs().t()).numpy() * np.abs(scale)
    tol = D * 2.0 ** -24 * abs_sum
    assert np.abs(ref).max() > 0.5  # the comparison is not vacuous
    assert np.all(np.abs(got - ref) <= tol), float(np.max(np.abs(got - ref) - tol))
    for row in range(ROWS):
        n_ref, n_got = len(np.unique(ref[row])), len(np.unique(got[row]))
        assert n_ref > 30000, n_ref  # JAX keeps f32 logits: nearly every value distinct
        assert abs(n_got - n_ref) <= 0.01 * n_ref, (row, n_got, n_ref)
