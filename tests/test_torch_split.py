"""Kernel D's split-over-T arithmetic, in its plain version, against the
plain attention it must equal (flash_decode_plain), on the CPU.

The kernel cuts the keys at fixed absolute positions into splits, computes
(m, l, acc) partials per split and combines them in ascending split order,
skipping the splits in which a row sees nothing. In f32 the combine equals
the one-pass softmax up to f32 rounding order: rtol 1e-5, atol 1e-6 (values
of order 1). The cases put splits across the window's lower edge and the
ring's wrap, a position exactly on a split boundary, a cache of one split,
and dead rows. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from llm_inference_lab_tpu_torch.models.base import quantize_rows
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    SPLIT,
    decode_splits,
    flash_decode_plain,
    flash_decode_split_plain,
    Options,
)
from test_torch_decode_loop import one_thread  # noqa: F401

SPLIT_SMALL = 16

# (name, T, last positions of the two sequences, S, options)
CASES = [
    ("window edge inside a split", 128, (104, 90), 5, dict(window=40)),
    ("window edge on a split boundary", 128, (111, 79), 3, dict(window=48)),
    ("position on a split boundary", 128, (64, 48), 1, dict()),
    ("position just below a boundary", 128, (63, 127), 2, dict()),
    ("one split", 16, (15, 9), 4, dict()),
    ("ring wrap", 48, (100, 47), 5, dict(window=40, ring_len=48)),
    ("ring wrap on a boundary", 48, (96, 130), 3, dict(window=33, ring_len=48)),
    ("ring shorter plane", 32, (70, 20), 2, dict(window=30, ring_len=48)),
    ("softcap and scale", 128, (100, 30), 2, dict(window=50, softcap=5.0, scale=0.3)),
]


def _inputs(T, last, S, seed, int8=False):
    rng = np.random.default_rng(seed)
    B, H, KVH, D = 2, 4, 2, 16
    q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, KVH, T, D)).astype(np.float32))
    pos = torch.from_numpy((np.array(last)[:, None] - S + 1 + np.arange(S)).astype(np.int32))
    pos[1, 0] = -1  # a dead row
    if not int8:
        return q, k, v, pos, ()
    (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    return q, k, v, pos, (ks, vs)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name,T,last,S,opts", CASES, ids=[c[0] for c in CASES])
def test_split_combine_equals_one_pass(name, T, last, S, opts, int8):
    q, k, v, pos, sc = _inputs(T, last, S, seed=len(name) + T, int8=int8)
    ref = flash_decode_plain(q, k, v, pos, *sc, **opts)
    got = flash_decode_split_plain(q, k, v, pos, *sc, split=SPLIT_SMALL, **opts)
    assert torch.isfinite(got).all()
    assert torch.all(got[1, 0] == 0)  # the dead row
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    # One split holding every key is the one-pass softmax too.
    whole = flash_decode_split_plain(q, k, v, pos, *sc, split=1 << 20, **opts)
    np.testing.assert_allclose(whole.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_decode_splits_cover_the_rows():
    """grid.z never depends on the rows' values, and covers every split a
    block's keys can touch: all of T without a window, the window and the
    rows' spread with one (and always with a ring, whose positions run past
    T)."""
    assert decode_splits(256, 1, Options()) == 1
    assert decode_splits(4480, 2, Options()) == -(-4480 // SPLIT)
    # Gemma-2's local layer at T = 4480: the window and T both give 18.
    assert decode_splits(4480, 2, Options(window=4096)) == 18
    # Mistral's ring: the window plus S - 1 rows, whatever T is.
    assert decode_splits(4736, 5, Options(window=4096, ring_len=4736)) == 18
    assert decode_splits(256, 1, Options(window=4096, ring_len=4736)) == 17
    for p in range(0, 6000, 37):
        for S in (1, 5):
            lo, hi = max(p - 4096 + 1, 0), p + S - 1
            spanned = hi // SPLIT - lo // SPLIT + 1
            assert spanned <= decode_splits(4736, S, Options(window=4096, ring_len=4736))
