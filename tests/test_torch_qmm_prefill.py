"""Kernels A and B at prefill shapes (M >= MMA_MIN_M, the tensor-core
path of csrc/qmm_mma.cuh on the card) against the JAX function the
reference's dispatcher runs there, on the CPU.

The JAX package's quant_matmul dispatcher sends M > 32 to quant_matmul_xla
(ops/pallas/quant_matmul.py:299-306), so that is the reference here, at
M = 64, 160 and 512, for int4 and int8 weights at narrow widths (K, N of
256 and 512). On the CPU the port's wrappers run their plain versions;
tests/test_torch_cuda.py holds the kernels to those on the card. The
tolerances are test_torch_quant.py's, relative to the output's largest
magnitude: f32 1e-5 (summation order), bf16 2e-2 (every output rounds to
bf16, ~2^-8, and the two sides sum in another order). Inputs are made with
numpy from a seed. The route and the tensor-core path's K split are pure
Python and tested here: M decides the route only through MMA_MIN_M, so
every decode and verify shape (1 to 40 rows) stays on the decode body,
and the split is a function of (K, N) and the weight type, never of M.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops import quant as jq
from llm_inference_lab_tpu_torch.convert import to_tensor
from llm_inference_lab_tpu_torch.ops.quant_matmul import (
    MMA_KTILE,
    MMA_MIN_M,
    mma_plan,
    quant_matmul,
    quant_matmul_int8,
    quant_matmul_int8_mma,
    quant_matmul_mma,
    takes_mma,
)

PREFILL_M = (64, 160, 512)
# (K, N) of every projection the paths run: the 3B, 1B, Gemma-2 9B and 2B,
# Mistral-7B, and Mistral's untied head.
PATH_SHAPES = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072),
               (2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
               (3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584),
               (2304, 4096), (2048, 2304), (2304, 18432), (9216, 2304),
               (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(256, 256), (512, 512), (512, 256)])
@pytest.mark.parametrize("bits", [4, 8])
def test_prefill_matches_quant_matmul_xla(bits, K, N, dtype):
    rng = np.random.default_rng(bits * 1000 + K + N)
    w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
    qt = (jq.quantize_int4 if bits == 4 else jq.quantize_int8)(jnp.asarray(w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 1e-5 if dtype == "float32" else 2e-2
    tw, ts = to_tensor(qt.data), to_tensor(qt.scale)
    kernel, mma = (quant_matmul, quant_matmul_mma) if bits == 4 else (quant_matmul_int8,
                                                                      quant_matmul_int8_mma)
    for M in PREFILL_M:
        jx = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(jdt)
        got = kernel(to_tensor(jx), tw, ts)
        assert got.dtype == tdt and got.shape == (M, N)
        # The tensor-core path's wrapper is the same function on the CPU.
        assert torch.equal(mma(to_tensor(jx), tw, ts), got)
        ref = np.asarray(jq.quant_matmul_xla(jx, qt).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=rtol * np.abs(ref).max())


def test_route_depends_on_m_only_through_mma_min_m():
    """Every decode and verify shape of the paths (B=1 draft and verify at
    K = 1 and 4, the 8-slot serving step up to its K=4 verify of 40 rows)
    stays on the decode body (csrc/qmm_decode.cuh); every prefill (a
    160-row prompt, Mistral's 512-row chunks, admission waves of G x P
    rows) takes the tensor-core path."""
    assert MMA_MIN_M == 64
    for M in (1, 2, 5, 8, 16, 40, MMA_MIN_M - 1):
        assert not takes_mma(M), M
    for M in (MMA_MIN_M, 160, 512, 1024, 2048, 4096):
        assert takes_mma(M), M


def test_mma_plan_is_a_function_of_k_n_and_bits():
    """The split has no M to depend on, divides the k-tiles, leaves at least
    16 k-tiles a split, and never splits int4; the k-tile is fixed."""
    assert list(inspect.signature(mma_plan).parameters) == ["K", "N", "bits"]
    assert MMA_KTILE == 64
    for K, N in PATH_SHAPES:
        for bits in (4, 8):
            ks = mma_plan(K, N, bits)
            nk = K // MMA_KTILE
            assert nk % ks == 0 and nk // ks >= 16, (K, N, bits, ks)
            assert ks == 1 if bits == 4 else ks == (2 if N <= 4096 else 1), (K, N, bits, ks)


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.default_rng(3)
    w = jq.quantize_int8(jnp.asarray(rng.normal(0, 0.02, (256, 256)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (160, 256)).astype(np.float32))
    counts = [f.launches for f in (quant_matmul, quant_matmul_mma, quant_matmul_int8,
                                    quant_matmul_int8_mma)]
    quant_matmul_int8(x, to_tensor(w.data), to_tensor(w.scale))
    assert counts == [f.launches for f in (quant_matmul, quant_matmul_mma, quant_matmul_int8,
                                            quant_matmul_int8_mma)]
