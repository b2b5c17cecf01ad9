"""Ragged <-> rectangular batch utilities (a copy of
llm_inference_lab_tpu/utils/sequence.py: numpy on the host, the same
results exactly).

The engine's DecodeState keeps a fixed [B, max_len] buffer and lengths, so
padding is never undone mid-decode. These helpers serve the boundaries
(host-side prompt packing, result unpadding) and length-grouped admission
(the SequencePool's scheduling idea).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pad_sequences(
    seqs: Sequence[Sequence[int]], pad_id: int = 0, multiple: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad to the batch max (rounded up to `multiple`).
    Returns (tokens [B, P], lengths [B])."""
    lens = np.array([len(s) for s in seqs], np.int32)
    P = int(max(lens.max() if len(lens) else 1, 1))
    P = ((P + multiple - 1) // multiple) * multiple
    out = np.full((len(seqs), P), pad_id, np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lens


def unpad_sequences(tokens: np.ndarray, lengths: np.ndarray) -> List[List[int]]:
    return [tokens[i, : lengths[i]].tolist() for i in range(tokens.shape[0])]


def attention_mask(lengths: np.ndarray, padded_len: int) -> np.ndarray:
    """[B, P] 1=real token, 0=pad."""
    return (np.arange(padded_len)[None, :] < lengths[:, None]).astype(np.int32)


def position_ids(lengths: np.ndarray, padded_len: int) -> np.ndarray:
    """[B, P] 0..len-1 per sequence, pad positions clamped to len-1 (pads
    are masked out of attention; clamping keeps positions in range)."""
    pos = np.broadcast_to(np.arange(padded_len)[None, :], (len(lengths), padded_len))
    return np.minimum(pos, np.maximum(lengths[:, None] - 1, 0)).astype(np.int32)


def group_by_length(
    lengths: Sequence[int],
    max_group_size: int,
    bucket: int = 1,
) -> List[List[int]]:
    """Length-aware grouping: indices whose (bucketed) length matches batch
    together, same-length groups first, leftovers in mixed batches."""
    buckets: Dict[int, List[int]] = {}
    for i, ln in enumerate(lengths):
        buckets.setdefault(ln // bucket, []).append(i)
    groups: List[List[int]] = []
    leftovers: List[int] = []
    for _, idxs in sorted(buckets.items()):
        while len(idxs) >= max_group_size:
            groups.append(idxs[:max_group_size])
            idxs = idxs[max_group_size:]
        leftovers.extend(idxs)
    for i in range(0, len(leftovers), max_group_size):
        groups.append(leftovers[i : i + max_group_size])
    return groups
