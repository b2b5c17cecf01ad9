"""Kernels A and B below MMA_MIN_M rows (every decode and verify call; the
decode body of csrc/qmm_decode.cuh on the card) against the JAX functions,
on the CPU.

At decode M the JAX package's dispatcher runs quant_matmul_pallas (all rows
in one block), so the references here are quant_matmul_pallas with
interpret=True and quant_matmul_xla, at the serving step's M = 5, 8, 16 and
40 and the largest decode M, 63, for int4 and int8 weights at narrow widths
(K, N of 256 to 512). On the CPU the port's wrappers run their plain
versions; tests/test_torch_cuda.py holds the kernel to those on the card.
The tolerances are test_torch_quant.py's, relative to the output's largest
magnitude: f32 1e-5 (summation order; the Pallas int4 body refactors the
nibbles into two dots), bf16 2e-2 (every output rounds to bf16, ~2^-8, and
the Pallas int4 prep rounds x_lo - x_hi/16 to bf16). Inputs are made with
numpy from a seed. The decode plan is pure Python and tested here: its K
split is a function of (K, N) and the weight type, never of M, cuts K into
whole k-tiles in ascending ranges, and gives every projection of the five
widths the paths run at least DECODE_MIN_BLOCKS blocks.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu.ops.pallas.quant_matmul import quant_matmul_pallas
from llm_inference_lab_tpu_torch.convert import to_tensor
from llm_inference_lab_tpu_torch.ops.quant_matmul import (
    DECODE_BN,
    DECODE_KTILE,
    DECODE_MIN_BLOCKS,
    SMS,
    decode_plan,
    quant_matmul,
    quant_matmul_int8,
    takes_mma,
)
from test_torch_decode_loop import one_thread  # noqa: F401

DECODE_M = (5, 8, 16, 40, 63)
# (K, N) of every projection the paths run: the 3B and 1B, Gemma-2 9B and
# 2B, Mistral-7B and its untied head.
PATH_SHAPES = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072),
               (2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
               (3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584),
               (2304, 4096), (2048, 2304), (2304, 18432), (9216, 2304),
               (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000)]


def split_ranges(K, N, bits):
    """The k-tile range of each split, as the kernel computes it."""
    nk = (K // 2 if bits == 4 else K) // DECODE_KTILE
    ks = decode_plan(K, N, bits)
    return nk, [(z * nk // ks, (z + 1) * nk // ks) for z in range(ks)]


@pytest.mark.parametrize("bits", [4, 8])
def test_decode_plan_is_a_function_of_k_n_and_bits(bits):
    """No M to depend on; whole k-tiles, each in exactly one split, in
    ascending ranges, none empty; at least DECODE_MIN_BLOCKS blocks (one an
    SM: most of the 132 SMs busy) and no more than two an SM; the same
    split at 4 and 8 bits."""
    assert list(inspect.signature(decode_plan).parameters) == ["K", "N", "bits"]
    assert DECODE_BN == 256 and DECODE_KTILE == 64 and DECODE_MIN_BLOCKS == 96 and SMS == 132
    for K, N in PATH_SHAPES:
        rows = K // 2 if bits == 4 else K
        assert rows % DECODE_KTILE == 0 and N % DECODE_BN == 0, (K, N)
        nk, ranges = split_ranges(K, N, bits)
        assert ranges[0][0] == 0 and ranges[-1][1] == nk, (K, N, bits)
        assert all(a < b for a, b in ranges), (K, N, bits, ranges)
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
        blocks = N // DECODE_BN * len(ranges)
        assert DECODE_MIN_BLOCKS <= blocks <= 2 * SMS, (K, N, bits, blocks)
        # The split follows the column tiles: int4 and int8 cut K alike.
        assert len(ranges) == decode_plan(K, N, 4), (K, N, bits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(256, 256), (512, 384)])
@pytest.mark.parametrize("bits", [4, 8])
def test_decode_matches_pallas_and_xla(bits, K, N, dtype):
    rng = np.random.default_rng(bits * 100 + K + N)
    w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
    qt = (jq.quantize_int4 if bits == 4 else jq.quantize_int8)(jnp.asarray(w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 1e-5 if dtype == "float32" else 2e-2
    tw, ts = to_tensor(qt.data), to_tensor(qt.scale)
    kernel = quant_matmul if bits == 4 else quant_matmul_int8
    for M in DECODE_M:
        assert not takes_mma(M)
        jx = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(jdt)
        got = kernel(to_tensor(jx), tw, ts)
        assert got.dtype == tdt and got.shape == (M, N)
        got = got.float().numpy()
        for ref in (quant_matmul_pallas(jx, qt, interpret=True), jq.quant_matmul_xla(jx, qt)):
            ref = np.asarray(ref.astype(jnp.float32))
            np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())
