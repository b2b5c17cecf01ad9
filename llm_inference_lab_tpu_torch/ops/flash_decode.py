"""Online-softmax decode attention over a contiguous bf16 or int8 KV cache.

Port of llm_inference_lab_tpu/ops/pallas/flash_decode.py, chain-decode
variants (mask kv_pos <= p) over a bf16 cache (_kernel) and an int8 cache
with per-row scales (_kernel_quant), with the tile body's static options
(``Options``): the score ``scale`` (default D**-0.5), the logit ``softcap``,
the sliding ``window`` and the rolling-buffer cache's ``ring_len``. On a CPU
tensor ``flash_decode`` runs the plain version; on a CUDA tensor it launches
csrc/flash_decode.cu or raises. An int8 cache goes to ``flash_decode_int8``,
the int8 instantiation of the same kernel with its own launch count.
``attend`` sends it the decode-shaped calls (S <= 32: draft S = 1, verify
S = K+1); longer S goes to flash_prefill.

    flash_decode(q [B,S,H,D], k [B,KVH,T,D], v [B,KVH,T,D], positions [B,S],
                 k_scale [B,KVH,T] = None, v_scale [B,KVH,T] = None,
                 scale=None, softcap=None, window=None, ring_len=None)
        -> [B,S,H,D] in q's dtype

A query at position p sees keys (p - window, p] (all of [0, p] without a
window). With ring_len R (which needs a window), slot s of the cache holds
the latest position <= p congruent to s mod R: it is seen iff rel = (p - s)
mod R satisfies rel < window and rel <= p, as attend_xla's ring branch
says. R is the ring's length, not T: a cache shorter than the ring (T < R)
holds the slots [0, T). A query row with no visible key (position -1)
returns zeros, as attend_xla does; the Pallas tile body returns the mean of
V there. The tree variant (``flash_decode_tree``, attend_xla's tree branch,
for tree speculation's verify chunk) takes an ancestry mask tree_mask
[S, S] and the chunk's first slot chunk_start [B] instead of positions:
row s sees every slot before chunk_start[b], slot chunk_start[b] + j iff
tree_mask[s, j], and nothing after the chunk.

The kernel (csrc/attn_mma.cuh on tensor cores) splits the keys at fixed
absolute positions into SPLIT-key splits over grid.z (``decode_splits``)
and combines the f32 partials in its last block; ``flash_decode_split_plain``
is that arithmetic written plainly, for the CPU tests. It rounds p to bf16
before P.V, as Pallas does, so it is held to the plain version within a
tolerance on the card (chip_smoke.check_attn), while a row's bits do not
depend on S, T or the rows beside it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from llm_inference_lab_tpu_torch import build

RING_MIN = 64  # the kernels' key tile: a shorter ring is refused on the card
SPLIT = 256  # kernel D's split of the keys, at fixed absolute positions (csrc/attn_mma.cuh)
ROWS = 64  # query rows a block of kernels D and E


def dequantize_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor]):
    """An int8 cache dequantized to q's dtype, as attend_xla does (f32
    product with the row scales, then the cast); a bf16 cache as it is."""
    if k.dtype != torch.int8:
        return k, v
    return ((k.float() * k_scale[..., None]).to(q.dtype),
            (v.float() * v_scale[..., None]).to(q.dtype))


class Options(NamedTuple):
    """The tile body's static options (_accum_tile's scale, softcap, window
    and ring_len; None is off, and the score scale then D**-0.5)."""

    scale: Optional[float] = None
    softcap: Optional[float] = None
    window: Optional[int] = None
    ring_len: Optional[int] = None

    def check(self) -> None:
        if self.softcap is not None and not self.softcap > 0:
            raise ValueError(f"softcap must be positive, got {self.softcap}")
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be at least 1, got {self.window}")
        if self.ring_len is not None:
            if self.ring_len < 1:
                raise ValueError(f"ring_len must be at least 1, got {self.ring_len}")
            if self.window is None:
                raise ValueError("ring_len needs a window (the ring keeps only the rows a "
                                 "window can see)")

    def kernel_args(self, D: int):
        """(scale, softcap, window) as the C entries take them: 0 turns
        softcap and window off. The ring's length goes to kernels D and E
        only (launch_planes)."""
        return (D ** -0.5 if self.scale is None else self.scale, self.softcap or 0.0,
                self.window or 0)


def tree_visible(T: int, tree_mask: torch.Tensor, chunk_start: torch.Tensor) -> torch.Tensor:
    """attend_xla's tree mask [B, S, T]: slot t is visible to row s of
    sequence b iff t < chunk_start[b], or t = chunk_start[b] + j with j < S
    and tree_mask[s, j]."""
    S = tree_mask.shape[0]
    rel = (torch.arange(T, device=chunk_start.device)[None] - chunk_start[:, None].long())
    in_chunk = (rel >= 0) & (rel < S)
    anc = tree_mask.to(chunk_start.device)[:, rel.clamp(0, S - 1)].permute(1, 0, 2)
    return (rel < 0)[:, None] | (in_chunk[:, None] & anc)


def tree_bits(tree_mask: torch.Tensor) -> torch.Tensor:
    """The kernels' form of an ancestry mask [S, S] (S <= 32): int32 [S], bit
    j of row s set iff tree_mask[s, j] (bit 31 as the sign)."""
    S = tree_mask.shape[0]
    if S > 32:
        raise NotImplementedError(f"a tree verify chunk of {S} rows: the card's tree variant "
                                  "takes at most 32 (num_nodes + 1 <= 32)")
    # Device ops only (no host copy), so a captured forward may call it.
    one = torch.ones((S,), dtype=torch.int64, device=tree_mask.device)
    word = (tree_mask.long() * (one << torch.arange(S, device=tree_mask.device))).sum(-1)
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


def _check_tree(tree_mask: torch.Tensor, chunk_start: torch.Tensor, B: int, S: int,
                options: dict) -> None:
    if tree_mask.shape != (S, S) or tree_mask.dtype != torch.bool:
        raise ValueError(f"tree_mask must be bool [S, S] = [{S}, {S}], got "
                         f"{tuple(tree_mask.shape)} {tree_mask.dtype}")
    if chunk_start.shape != (B,):
        raise ValueError(f"chunk_start must be [B] = [{B}], got {tuple(chunk_start.shape)}")
    if options.get("window") is not None or options.get("ring_len") is not None:
        raise NotImplementedError("the tree mask takes no window or ring (attend_xla's tree "
                                  "branch has none)")


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
                       softcap: Optional[float] = None, window: Optional[int] = None,
                       ring_len: Optional[int] = None, tree_mask: Optional[torch.Tensor] = None,
                       chunk_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """attend_xla's chain-decode math in f32, in its order: an int8 cache
    dequantized to q's dtype, scores times the scale, the softcap, the
    position mask (with the window's lower bound; with a ring, the modular
    rule rel = (p - slot) mod ring_len < window and rel <= p; with
    tree_mask and chunk_start, the tree mask of tree_visible instead),
    softmax, zeros on rows with no visible key, probabilities rounded to the
    cache dtype before P @ V (as attend_xla rounds them)."""
    Options(scale, softcap, window, ring_len).check()
    k, v = dequantize_cache(q, k, v, k_scale, v_scale)
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    group = H // KVH
    qg = q.reshape(B, S, KVH, group, D).float()
    scores = torch.einsum("bsngd,bntd->bngst", qg, k.float()) * (D ** -0.5 if scale is None
                                                                  else scale)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    kv_pos = torch.arange(T, device=q.device)[None, None, None, None, :]
    p = positions[:, None, None, :, None]
    if tree_mask is not None:
        _check_tree(tree_mask, chunk_start, B, S, dict(window=window, ring_len=ring_len))
        mask = tree_visible(T, tree_mask, chunk_start)[:, None, None]
    elif ring_len is not None:
        rel = (p - kv_pos) % ring_len
        mask = (rel < window) & (rel <= p)
    else:
        mask = kv_pos <= p
        if window is not None:
            mask &= kv_pos > p - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bngst,bntd->bsngd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             positions: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None, *, split: int = SPLIT,
                             scale: Optional[float] = None, softcap: Optional[float] = None,
                             window: Optional[int] = None, ring_len: Optional[int] = None,
                             tree_mask: Optional[torch.Tensor] = None,
                             chunk_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel D's split-and-combine arithmetic, plainly (the CPU tests hold it
    to flash_decode_plain; the wrapper never calls it). The keys a row sees
    are cut at fixed absolute positions into splits of `split` keys (with a
    ring, slot s stands for the position p - (p - s) mod ring_len it holds
    for the row at p). Split i gives f32 partials: m_i, the largest score;
    l_i, the sum of exp(s - m_i); acc_i, the sum of p * v with p (for int8
    times v's per-key scale) rounded to q's dtype, the cache's compute dtype,
    as the kernel rounds it before its P.V product. The combine takes the
    splits in which the row sees a key, in ascending order: M = max m_i,
    w_i = exp(m_i - M), out = sum w_i acc_i / sum w_i l_i; zeros for a row
    that sees no key. Scores follow the kernel's order: q.k times the scale,
    for int8 times k's per-key scale, then the softcap. With tree_mask and
    chunk_start (the tree variant) a row sees tree_visible's keys, split at
    their slots, up to the chunk's last slot."""
    Options(scale, softcap, window, ring_len).check()
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    group = H // KVH
    int8 = k.dtype == torch.int8
    qg = q.reshape(B, S, KVH, group, D).float()
    scores = torch.einsum("bsngd,bntd->bngst", qg, k.float()) * (D ** -0.5 if scale is None
                                                                  else scale)
    if int8:
        scores = scores * k_scale[:, :, None, None, :]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    slot = torch.arange(T, device=q.device)[None, None, None, None, :]
    p = positions[:, None, None, :, None]
    if tree_mask is not None:
        _check_tree(tree_mask, chunk_start, B, S, dict(window=window, ring_len=ring_len))
        kv_pos = slot.expand_as(scores)
        mask = tree_visible(T, tree_mask, chunk_start)[:, None, None]
        positions = (chunk_start[:, None] + S - 1).expand(B, S)  # the last key a row may see
    elif ring_len is not None:
        kv_pos = p - (p - slot) % ring_len  # the position the slot holds for this row
        mask = (p - kv_pos < window) & (kv_pos >= 0)
    else:
        kv_pos = slot.expand_as(scores)
        mask = kv_pos <= p
        if window is not None:
            mask &= kv_pos > p - window
    mask = mask.expand_as(scores)
    which = torch.div(kv_pos, split, rounding_mode="floor").expand_as(scores)
    vf = v.float()
    parts = []
    for i in range(int(positions.max()) // split + 1 if positions.numel() else 0):
        seen = mask & (which == i)
        s_i = scores.masked_fill(~seen, float("-inf"))
        hit = seen.any(-1, keepdim=True)
        m_i = torch.where(hit, s_i.amax(-1, keepdim=True), torch.zeros_like(s_i[..., :1]))
        pe = torch.exp(s_i - m_i)
        l_i = pe.sum(-1, keepdim=True)
        if int8:
            pe = pe * v_scale[:, :, None, None, :]
        acc_i = torch.einsum("bngst,bntd->bngsd", pe.to(q.dtype).float(), vf)
        parts.append((hit, torch.where(hit, m_i, torch.full_like(m_i, float("-inf"))), l_i,
                      acc_i))
    out = torch.zeros((B, KVH, group, S, D), device=q.device)
    if parts:
        M = torch.stack([m for _, m, _, _ in parts]).amax(0)
        den = torch.zeros_like(M)
        num = torch.zeros_like(out)
        for hit, m_i, l_i, acc_i in parts:  # ascending split order
            w = torch.where(hit, torch.exp(m_i - torch.where(hit, M, m_i)), torch.zeros_like(m_i))
            den = den + w * l_i
            num = num + w * acc_i
        out = torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)), out)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def decode_splits(T: int, S: int, opts: Options) -> int:
    """Kernel D's grid.z: how many SPLIT-key splits a block's rows can span.
    Without a window, every position below T: ceil(T / SPLIT). With one (and
    always with a ring, whose positions run past T), the window plus the
    rows' spread, which the engine's consecutive positions keep below S:
    ceil((window + S - 1) / SPLIT) + 1. The kernel writes NaN rather than a
    wrong row if a block's rows span more."""
    n = -(-T // SPLIT)
    if opts.window is None:
        return n
    w = min(opts.window, opts.ring_len) if opts.ring_len is not None else opts.window
    n_w = -(-(w + S - 1) // SPLIT) + 1
    return n_w if opts.ring_len is not None else min(n, n_w)


_counters: dict = {}
# Every counter buffer a larger one replaced. A CUDA graph captured a launch
# with the buffer's address and replays it for as long as the graph lives, so
# no buffer is ever freed.
_outgrown: list = []


def ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """kernel D's ticket counters on `device`: zeros, at least n of them.
    The last block of a row block resets its counter to 0, so the buffer is
    zeroed once, when it is made, and shared by every call in stream order."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _outgrown.append(buf)
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def split_buffers(q: torch.Tensor, KVH: int, T: int, opts: Options):
    """Kernels D and F split the keys over grid.z and combine in their last
    block: (workspace from the caching allocator, ticket counters, nz), the
    buffers None when nz = 1. Keep them referenced until the launch."""
    B, S, H, D = q.shape
    nz = decode_splits(T, S, opts)
    if nz == 1:
        return None, None, nz
    nblk = B * KVH * -(-S * (H // KVH) // ROWS)
    ws = torch.empty((nblk * nz * ROWS * (D + 2),), dtype=torch.float32, device=q.device)
    return ws, ticket_counters(q.device, nblk), nz


def data_ptrs(*tensors):
    """The tensors' addresses for a C entry, 0 for None."""
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def check_queries(name: str, q: torch.Tensor, positions: torch.Tensor, *caches: torch.Tensor,
                  cache_dtype: torch.dtype = torch.bfloat16):
    """The checks every attention kernel makes on q, positions and its K/V
    tensors: bf16 q, caches of cache_dtype, D in {64, 128, 256}, int32 positions
    [B, S], contiguous q and positions, one device, 16-byte aligned q and
    caches (the kernels read 16-byte vectors: a misaligned view would fault
    on the card after the launch). Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    if q.dtype != torch.bfloat16 or any(c.dtype != cache_dtype for c in caches):
        raise TypeError(f"{name} kernel takes bf16 q and {cache_dtype} caches")
    if positions.dtype != torch.int32 or positions.shape != (B, S):
        raise TypeError(f"{name} kernel takes int32 positions [B, S]")
    if D not in (64, 128, 256):
        raise ValueError(f"{name} kernel: head dim {D} is not 64, 128 or 256")
    if not (q.is_contiguous() and positions.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous q and positions")
    if any(t.device != q.device for t in (positions, *caches)):
        raise ValueError(f"{name} kernel needs all operands on one device")
    if any(t.data_ptr() % 16 for t in (q, *caches)):
        raise ValueError(f"{name} kernel needs 16-byte aligned q and caches")
    return B, S, H, D


def check_planes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """k and v [B, KVH, T, D] with equal strides and unit-stride [T, D]
    planes at 16-byte aligned batch and head strides (a layer's view of the
    stacked cache qualifies)."""
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if H % KVH or k.shape != (B, KVH, T, D) or v.shape != k.shape:
        raise ValueError(f"{name} kernel: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D:
        raise ValueError(f"{name} kernel needs k and v with equal strides and [T, D] planes")
    if (k.stride(0) * k.element_size()) % 16 or (k.stride(1) * k.element_size()) % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned plane strides")


def check_scales(name: str, k: torch.Tensor, k_scale: torch.Tensor, v_scale: torch.Tensor) -> None:
    """The scales of an int8 cache or pool k [X, KVH, R, D]: f32 [X, KVH, R]
    on k's device, both with the same strides and unit stride along R."""
    if k_scale is None or v_scale is None:
        raise ValueError(f"{name}: an int8 cache needs its k and v scales")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes f32 scales")
    if k_scale.shape != k.shape[:3] or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name} kernel: scales {tuple(k_scale.shape)} do not match the cache "
                         f"{tuple(k.shape)}")
    if k_scale.stride() != v_scale.stride() or k_scale.stride(2) != 1:
        raise ValueError(f"{name} kernel needs k and v scales with equal strides, unit along T")
    if k_scale.device != k.device or v_scale.device != k.device:
        raise ValueError(f"{name} kernel needs all operands on one device")


def launch_planes(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor], opts: Options) -> torch.Tensor:
    """Check the operands of kernel D or E (`kernel` is "flash_decode" or
    "flash_prefill") over a contiguous cache and launch its bf16 entry, or
    its int8 entry with the scale planes when k is int8."""
    opts.check()
    int8 = k.dtype == torch.int8
    name = kernel + ("_int8" if int8 else "")
    B, S, H, D = check_queries(name, q, positions, k, v,
                               cache_dtype=torch.int8 if int8 else torch.bfloat16)
    check_planes(name, q, k, v)
    if opts.ring_len is not None and opts.ring_len < RING_MIN:
        raise ValueError(f"{name} kernel takes ring_len >= {RING_MIN} (a tile of keys), "
                         f"got {opts.ring_len}")
    KVH, T = k.shape[1], k.shape[2]
    ring = opts.ring_len or 0  # 0: slot == position
    out = torch.empty_like(q)
    lib = build.library(kernel)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    split, nsplit = (), ()
    if kernel == "flash_decode":
        ws, counters, nz = split_buffers(q, KVH, T, opts)
        split = data_ptrs(ws, counters)
        nsplit = (nz,)
    if int8:
        check_scales(name, k, k_scale, v_scale)
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            positions.data_ptr(), out.data_ptr(), *split, B, S, H, KVH, T, D, k.stride(0),
            k.stride(1), k_scale.stride(0), k_scale.stride(1), *opts.kernel_args(D), ring,
            *nsplit, stream)
    else:
        err = getattr(lib, f"{kernel}_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), out.data_ptr(),
            *split, B, S, H, KVH, T, D, k.stride(0), k.stride(1), *opts.kernel_args(D), ring,
            *nsplit, stream)
    build.check(err, name)
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
                 **options) -> torch.Tensor:
    """options: the keywords of Options (scale, softcap, window, ring_len)."""
    if k.dtype == torch.int8:
        return flash_decode_int8(q, k, v, positions, k_scale, v_scale, **options)
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions, **options)
    out = launch_planes("flash_decode", q, k, v, positions, None, None, Options(**options))
    flash_decode.launches += 1
    return out


def flash_decode_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor, **options) -> torch.Tensor:
    """flash_decode over an int8 cache k, v [B, KVH, T, D] with f32 scales
    [B, KVH, T]."""
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions, k_scale, v_scale, **options)
    out = launch_planes("flash_decode", q, k, v, positions, k_scale, v_scale, Options(**options))
    flash_decode_int8.launches += 1
    return out


flash_decode.launches = 0
flash_decode_int8.launches = 0


def launch_tree(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                tree_mask: torch.Tensor, chunk_start: torch.Tensor, opts: Options,
                bits: Optional[torch.Tensor], table: Optional[torch.Tensor] = None,
                name: str = "") -> torch.Tensor:
    """Check the tree operands of D's or F's tree variant (kernel
    "flash_decode" over planes k, v [B, KVH, T, D], or "paged_flash" over
    pools through `table`), the rest of the operands as their chain entries
    do, and launch its bf16 or int8 entry. bits: tree_bits(tree_mask),
    computed here when None."""
    opts.check()
    int8 = k.dtype == torch.int8
    B, S = q.shape[:2]
    _check_tree(tree_mask, chunk_start, B, S, opts._asdict())
    if S > 32:
        raise NotImplementedError(f"{name}: a tree verify chunk of {S} rows; the card's tree "
                                  "variant takes at most 32 (num_nodes + 1 <= 32)")
    if bits is None:
        bits = tree_bits(tree_mask)
    if bits.dtype != torch.int32 or bits.shape != (S,) or not bits.is_contiguous():
        raise TypeError(f"{name} kernel takes contiguous int32 tree bits [S]")
    if chunk_start.dtype != torch.int32 or not chunk_start.is_contiguous():
        raise TypeError(f"{name} kernel takes a contiguous int32 chunk_start [B]")
    if bits.device != q.device or chunk_start.device != q.device:
        raise ValueError(f"{name} kernel needs all operands on one device")
    positions = torch.empty((B, S), dtype=torch.int32, device=q.device)  # the checks' shape
    lib = build.library(kernel + "_tree")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale, softcap, _ = opts.kernel_args(q.shape[3])
    out = torch.empty_like(q)
    if kernel == "flash_decode":
        H, D = q.shape[2], q.shape[3]
        check_queries(name, q, positions, k, v,
                      cache_dtype=torch.int8 if int8 else torch.bfloat16)
        check_planes(name, q, k, v)
        KVH, T = k.shape[1], k.shape[2]
        ws, counters, nz = split_buffers(q, KVH, T, opts)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        dims = (B, S, H, KVH, T, D, k.stride(0), k.stride(1))
        if int8:
            check_scales(name, k, k_scale, v_scale)
            err = lib.flash_decode_tree_int8(
                *head, k_scale.data_ptr(), v_scale.data_ptr(), bits.data_ptr(),
                chunk_start.data_ptr(), out.data_ptr(), *data_ptrs(ws, counters), *dims,
                k_scale.stride(0), k_scale.stride(1), scale, softcap, nz, stream)
        else:
            err = lib.flash_decode_tree_bf16(
                *head, bits.data_ptr(), chunk_start.data_ptr(), out.data_ptr(),
                *data_ptrs(ws, counters), *dims, scale, softcap, nz, stream)
    else:
        from llm_inference_lab_tpu_torch.ops.paged_flash import _check_pools

        _, _, H, D, KVH, P, M = _check_pools(name, q, k, v, positions, table,
                                             torch.int8 if int8 else torch.bfloat16)
        ws, counters, nz = split_buffers(q, KVH, M * P, opts)
        if int8:
            check_scales(name, k, k_scale, v_scale)
            if k_scale.stride(1) != P:
                raise ValueError(f"{name} kernel needs scale pools with [KVH, P] pages")
            err = lib.paged_flash_tree_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                table.data_ptr(), bits.data_ptr(), chunk_start.data_ptr(), out.data_ptr(),
                *data_ptrs(ws, counters), B, S, H, KVH, M, P, D, k.stride(0), k_scale.stride(0),
                scale, softcap, nz, stream)
        else:
            err = lib.paged_flash_tree_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), bits.data_ptr(),
                chunk_start.data_ptr(), out.data_ptr(), *data_ptrs(ws, counters), B, S, H, KVH,
                M, P, D, k.stride(0), scale, softcap, nz, stream)
    build.check(err, name)
    return out


def flash_decode_tree(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      tree_mask: torch.Tensor, chunk_start: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      bits: Optional[torch.Tensor] = None, **options) -> torch.Tensor:
    """Kernel D's tree variant: the verify chunk of tree speculation, q
    [B, S, H, D] at slots chunk_start[b] .. + S - 1, row s seeing the slots
    before the chunk and the chunk's slots tree_mask[s] names (bool [S, S];
    bits, its tree_bits, may be given). options: scale and softcap. On a
    CPU tensor the plain version; on a CUDA tensor the kernel,
    csrc/flash_decode_tree.cu (S <= 32, or NotImplementedError), or an
    error. An int8 cache goes to flash_decode_tree_int8."""
    if k.dtype == torch.int8:
        return flash_decode_tree_int8(q, k, v, tree_mask, chunk_start, k_scale, v_scale, bits,
                                      **options)
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, torch.zeros(q.shape[:2], dtype=torch.int32),
                                  tree_mask=tree_mask, chunk_start=chunk_start, **options)
    out = launch_tree("flash_decode", q, k, v, None, None, tree_mask, chunk_start,
                      Options(**options), bits, name="flash_decode_tree")
    flash_decode_tree.launches += 1
    return out


def flash_decode_tree_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           tree_mask: torch.Tensor, chunk_start: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           bits: Optional[torch.Tensor] = None, **options) -> torch.Tensor:
    """flash_decode_tree over an int8 cache with f32 scales [B, KVH, T]."""
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, torch.zeros(q.shape[:2], dtype=torch.int32), k_scale,
                                  v_scale, tree_mask=tree_mask, chunk_start=chunk_start,
                                  **options)
    out = launch_tree("flash_decode", q, k, v, k_scale, v_scale, tree_mask, chunk_start,
                      Options(**options), bits, name="flash_decode_tree_int8")
    flash_decode_tree_int8.launches += 1
    return out


flash_decode_tree.launches = 0
flash_decode_tree_int8.launches = 0
