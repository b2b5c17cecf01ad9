"""Kernel C's split over V, in its plain version, on the CPU.

The kernel (csrc/verify_prefix.cu) cuts each row's V columns into
``verify_plan(B * K, V)`` contiguous ranges of ``split_width`` columns, keeps
(max, lowest index, saw NaN) a range, and combines the ranges in the last
block of each sequence. ``verify_prefix_split_plain`` is that split and
combine in torch; it must equal ``verify_prefix_plain`` and the Pallas
kernel (``verify_prefix_pallas(..., interpret=True)``) exactly: ties to the
lowest index, also across a split boundary; any NaN rejects; an all -inf
row argmaxes to 0. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu.ops.pallas.verify_pallas import verify_prefix_pallas
from llm_inference_lab_tpu_torch.ops.verify import (
    BLOCKS_PER_SM,
    MIN_SPLIT,
    SMS,
    split_width,
    verify_plan,
    verify_prefix,
    verify_prefix_plain,
    verify_prefix_split_plain,
)
from test_torch_decode_loop import one_thread  # noqa: F401

VOCABS = (128256, 256000, 32000, 50257)


@pytest.mark.parametrize("V", VOCABS)
def test_verify_plan_covers_v_in_aligned_splits(V):
    """Every plan covers [0, V) with non-empty splits whose width is a
    multiple of 4 (16 bytes of f32), none narrower than MIN_SPLIT unless
    there is one, and no more blocks than the target once there are two
    splits; the plan is a function of (rows, V) alone."""
    for rows in (1, 2, 4, 5, 8, 16, 32, 40, 64, 300):
        n = verify_plan(rows, V)
        w = split_width(V, n)
        assert w % 4 == 0 and (n - 1) * w < V <= n * w, (rows, n, w)
        assert n == 1 or w >= MIN_SPLIT, (rows, n, w)
        assert n == 1 or rows * n <= BLOCKS_PER_SM * SMS, (rows, n)
        assert verify_plan(rows, V) == n
    assert verify_plan(1, V) > 8  # the main path's single row is spread over many blocks


def _case(name, rng):
    """(draft [B, K] int32, logits [B, K, V] f32, possibly a strided or
    unaligned view) for one named case."""
    shapes = {"main 128256": (1, 1, 128256), "main 256000": (1, 1, 256000),
              "main 32000": (1, 1, 32000), "strided [8,4,V]": (8, 4, 128256),
              "unaligned 50257": (2, 3, 50257), "tie across a split boundary": (2, 2, 128256),
              "NaN in the last split only": (2, 2, 32000), "special rows": (4, 4, 50257)}
    B, K, V = shapes[name]
    full = rng.normal(0, 1, (B, K + 1, V)).astype(np.float32)
    if name == "unaligned 50257":  # rows start 4 bytes past 16-byte boundaries
        flat = rng.normal(0, 1, B * K * V + 1).astype(np.float32)
        logits = flat[1:].reshape(B, K, V)
    else:
        logits = full[:, :K]  # the verify forward's first K of K+1 rows
    draft = np.argmax(logits, -1).astype(np.int32)
    w = split_width(V, verify_plan(B * K, V))
    if name == "tie across a split boundary":
        top = logits.max() + 1.0
        logits[0, 0, w - 1] = logits[0, 0, w] = top  # last of split 0, first of split 1
        logits[1, 1, 3 * w] = logits[1, 1, w + 5] = top  # split 1's index is the lower
        draft[0, 0], draft[1, 1] = w - 1, w + 5
        logits[0, 1, 2 * w] = logits[0, 1, 2 * w - 1] = top
        draft[0, 1] = 2 * w  # the higher index of the tie: rejects
    if name == "NaN in the last split only":
        logits[0, 0, V - 1] = np.nan
        logits[1, 1, (verify_plan(B * K, V) - 1) * w] = np.nan
    if name == "special rows":
        draft[1, 2] = (draft[1, 2] + 1) % V  # a mismatch mid-sequence
        logits[3, 1, 7] = logits[3, 1, 9000] = logits[3, 1].max() + 1.0  # a tie
        draft[3, 1] = 7
        logits[0, 3, 5] = np.nan  # a NaN in a matching row
        logits[2, 0, :] = np.nan  # an all-NaN row
        logits[3, 3, :] = -np.inf  # an all -inf row: argmax 0
        draft[3, 3] = 0
    return draft, logits


def _with_empty_splits(V):
    """A split count whose rounded width leaves the last splits empty."""
    return next(n for n in range(V // 64, V) if (n - 1) * split_width(V, n) >= V)


CASES = ["main 128256", "main 256000", "main 32000", "strided [8,4,V]", "unaligned 50257",
         "tie across a split boundary", "NaN in the last split only", "special rows"]


@pytest.mark.parametrize("name", CASES)
def test_split_plain_equals_plain_and_pallas(name):
    rng = np.random.default_rng(len(name))
    draft, logits = _case(name, rng)
    B, K, V = logits.shape
    d, lg = torch.from_numpy(draft), torch.from_numpy(logits)
    ref = verify_prefix_plain(d, lg)
    jl, jm = verify_prefix_pallas(jnp.asarray(draft), jnp.asarray(logits), interpret=True)
    np.testing.assert_array_equal(ref[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(jm))
    plan = verify_plan(B * K, V)
    # The plan's splits, one split, and counts that leave trailing splits
    # empty (they must not win).
    for splits in (plan, 1, 2, 3, plan + 7, _with_empty_splits(V)):
        got = verify_prefix_split_plain(d, lg, splits)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), splits
    got = verify_prefix(d, lg)  # the wrapper on a CPU tensor: the plain version
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_ties_and_nans_decide_as_specified():
    """The special cases read as the contract says, not only as the plain
    version does: ties to the lowest index across a boundary, NaN rejects,
    an all -inf row takes index 0."""
    rng = np.random.default_rng(5)
    draft, logits = _case("tie across a split boundary", rng)
    got = verify_prefix_split_plain(torch.from_numpy(draft), torch.from_numpy(logits),
                                    verify_plan(4, logits.shape[-1]))
    assert got[1].tolist() == [[True, False], [True, True]]
    draft, logits = _case("special rows", np.random.default_rng(6))
    got = verify_prefix_split_plain(torch.from_numpy(draft), torch.from_numpy(logits),
                                    verify_plan(16, logits.shape[-1]))
    assert got[0].tolist() == [3, 2, 0, 4]
