"""Kernel G's plain version (ops/tied_head.py), the int8 tied head read in
place, against the JAX package's EmbedQuant.head_logits.

JAX contracts bf16 x [M, D] with the int8 table [V, D] through dot_general
(preferred_element_type=f32) and multiplies the row scales in f32. Each
product of a bf16 and an int8 value is exact in f32, so the two differ only
in the order of the sum: per element within tests/test_torch_head.py's
bound, D * 2^-24 * sum_d |x_d q_d| * scale.

Inputs are made with numpy from a seed; the table is quantized by JAX's
quantize_embed and carried across by convert.params_from_jax. V = 32,003 is
a multiple of no tile; D = 768 and 2048 are GPT-2's and the 1B's widths; M
covers the B=1 heads (1, 2), an odd M (5) and the 8-slot ngram verify
(104). On a CPU tensor the wrapper runs the plain version, and no bf16
copy of the table is made (the CUDA path launches csrc/tied_head.cu, held
to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant
from llm_inference_lab_tpu_torch.ops.tied_head import tied_head, tied_head_plain
from test_torch_decode_loop import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V = 32003
WIDTHS = (768, 2048)
MS = (1, 2, 5, 104)


@pytest.fixture(scope="module")
def tables():
    """D -> (JAX's EmbedQuant, the port's) of one table, quantized by JAX."""
    rng = np.random.default_rng(25)
    out = {}
    for D in WIDTHS:
        jeq = jq.quantize_embed(jnp.asarray(rng.normal(0, 0.02, (V, D)).astype(np.float32)))
        out[D] = jeq, params_from_jax({"embed": jeq})["embed"]
    return out


def _x(M, D, seed):
    x = np.random.default_rng(seed).normal(0, 1, (M, D)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _bound(tx, teq):
    """D * 2^-24 * sum_d |x_d q_d| * |scale|: a sum of D terms in any order."""
    D = tx.shape[-1]
    abs_sum = tx.float().abs().reshape(-1, D) @ teq.q.float().abs().t()
    return (D * 2.0 ** -24 * abs_sum * teq.scale.abs()).numpy()


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("M", MS)
def test_plain_head_equals_jax_within_the_sum_order(tables, M, D):
    """EmbedQuant.head_logits on a CPU tensor (kernel G's plain version)
    equals JAX's head_logits within the f32 summation bound, f32 [M, V]."""
    jeq, teq = tables[D]
    assert isinstance(teq, EmbedQuant) and teq.q.dtype == torch.int8
    jx, tx = _x(M, D, M * D)
    want = np.asarray(jeq.head_logits(jx), np.float32)
    got = teq.head_logits(tx)
    assert got.dtype == torch.float32 and got.shape == (M, V)
    assert np.abs(want).max() > 0.1  # the comparison is not vacuous
    err = np.abs(got.numpy() - want) - _bound(tx, teq)
    assert np.all(err <= 0), float(err.max())


def test_cpu_wrapper_runs_plain_and_makes_no_bf16_table(tables):
    """The wrapper on CPU tensors: the plain version's bits, leading dims
    kept, no launch counted, and no op of the call outputs a bf16 [V, D]
    tensor (the copy of the table that the head made before kernel G)."""
    _, teq = tables[768]
    _, tx = _x(6, 768, 1)
    x3 = tx.reshape(2, 3, 768)
    made = []

    class Outputs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    made.append((tuple(t.shape), t.dtype))
            return out

    before = tied_head.launches
    with Outputs():
        got = teq.head_logits(x3)
    assert tied_head.launches == before
    assert got.shape == (2, 3, V) and got.dtype == torch.float32
    assert ((V, 768), torch.bfloat16) not in made, made
    assert torch.equal(got.reshape(6, V), tied_head_plain(tx, teq.q, teq.scale))
