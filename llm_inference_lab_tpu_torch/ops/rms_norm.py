"""RMSNorm whose rows do not depend on how many rows a call holds, alone and
fused with the residual add before it.

JAX computes rms_norm outside Pallas (llm_inference_lab_tpu/models/
transformer.py rms_norm, fused by XLA). torch's ``mean`` on the card chooses
its reduction by the shape of the call, so the same row can round
differently in a 5-row verify and a 256-row prefill; csrc/rms_norm.cu sums
each row in a fixed order in a block of its own. On a CPU tensor
``rms_norm`` and ``add_rms_norm`` run their plain versions; on a CUDA tensor
they launch the kernel or raise.

    rms_norm(x [.., N], w [N], eps, one_offset=False) -> [.., N] in x's dtype
    add_rms_norm(x, a, w, eps, one_offset=False, post_w=None)
        -> (x + a', rms_norm(x + a', w)), a' = rms_norm(a, post_w) or a

one_offset: Gemma's weights stored as (w - 1), so the weight is 1 + w in f32
(for both weights). ``add_rms_norm`` is every norm of a forward after the
first: the residual add of the layer loop and the norm that reads its result
in one launch, with Gemma-2's sandwich post-norm of a in the same launch.
Its outputs have the bits of ``rms_norm`` applied to torch's x + a'.

GPT-2's and OPT's LayerNorm (JAX models/transformer.py:41 layer_norm) runs
the same way through the same library:

    layer_norm(x [.., N], w [N], b [N], eps) -> [.., N] in x's dtype
    add_layer_norm(x, a, w, b, eps) -> (x + a, layer_norm(x + a, w, b))

the mean and the biased variance in f32, each row summed in a fixed order,
then (x - mean) * rsqrt(var + eps) * w + b rounded once; the add in x's
dtype. Their plain versions (``layer_norm_plain``, ``add_layer_norm_plain``)
are JAX's formula in f32 plain ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from llm_inference_lab_tpu_torch import build

ADD_NORM_MAX_N = 8192  # the fused kernel holds a row in registers: 4 chunks of 8 a thread
LIBRARY = "rms_norm"  # csrc/rms_norm.cu (rms_norm and add_rms_norm)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   one_offset: bool = False) -> torch.Tensor:
    """JAX's formula in f32: x32 * rsqrt(mean(x32 * x32) + eps) * scale."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    if one_offset:
        scale = 1.0 + scale.float()
    # A bf16 scale promotes to f32 inside the product: no separate cast.
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _check_weight(name: str, w: torch.Tensor, x: torch.Tensor) -> None:
    N = x.shape[-1]
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes a bf16 or f32 weight")
    if w.shape != (N,) or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"{name} kernel needs a contiguous weight [{N}] on x's device")


def _rows(name: str, x: torch.Tensor) -> torch.Tensor:
    """x contiguous (itself when it is: no view, no copy), bf16, rows of a
    length divisible by 8, 16-byte aligned. The wrappers run once a layer
    on a host-bound step, so they make no view they do not need."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 rows")
    if x.shape[-1] % 8:
        raise ValueError(f"{name} kernel needs a row length divisible by 8, got {x.shape[-1]}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned rows")
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             one_offset: bool = False) -> torch.Tensor:
    if not x.is_cuda:
        return rms_norm_plain(x, scale, eps, one_offset)
    x = _rows("rms_norm", x)
    _check_weight("rms_norm", scale, x)
    out = torch.empty_like(x)
    N = x.shape[-1]
    if x.numel() == 0:
        return out
    err = build.library(LIBRARY).rms_norm_bf16(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // N, N, float(eps),
        int(one_offset), int(scale.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rms_norm")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0


def add_rms_norm_plain(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, eps: float,
                       one_offset: bool = False, post_w: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused composition: a' = rms_norm_plain(a, post_w) (or a), x + a'
    in x's dtype, then rms_norm_plain of the sum."""
    if post_w is not None:
        a = rms_norm_plain(a, post_w, eps, one_offset)
    x = x + a
    return x, rms_norm_plain(x, w, eps, one_offset)


def add_rms_norm(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, eps: float,
                 one_offset: bool = False, post_w: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + a', rms_norm(x + a', w)) with a' = rms_norm(a, post_w) when post_w
    is given, in one launch; both outputs new tensors of x's shape."""
    if not x.is_cuda:
        return add_rms_norm_plain(x, a, w, eps, one_offset, post_w)
    if a.shape != x.shape or a.device != x.device:
        raise ValueError(f"add_rms_norm kernel needs a {tuple(x.shape)} on x's device, "
                         f"got {tuple(a.shape)}")
    x, a = _rows("add_rms_norm", x), _rows("add_rms_norm", a)
    N = x.shape[-1]
    if N > ADD_NORM_MAX_N:
        raise ValueError(f"add_rms_norm kernel holds rows of at most {ADD_NORM_MAX_N}, got {N}")
    _check_weight("add_rms_norm", w, x)
    if post_w is not None:
        _check_weight("add_rms_norm", post_w, x)
        if post_w.dtype != w.dtype:
            raise TypeError("add_rms_norm kernel takes two weights of one dtype")
    res, out = torch.empty_like(x), torch.empty_like(x)  # x + a', its norm
    if x.numel():
        err = build.library(LIBRARY).add_rms_norm_bf16(
            x.data_ptr(), a.data_ptr(), w.data_ptr(),
            0 if post_w is None else post_w.data_ptr(), res.data_ptr(), out.data_ptr(),
            x.numel() // N, N, float(eps), int(one_offset), int(w.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "add_rms_norm")
        add_rms_norm.launches += 1
    return res, out


add_rms_norm.launches = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """JAX's layer_norm in f32: the mean, the biased variance,
    (x - mean) * rsqrt(var + eps) * scale + bias, rounded to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def add_layer_norm_plain(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + a in x's dtype, then layer_norm_plain of the sum."""
    x = x + a
    return x, layer_norm_plain(x, w, b, eps)


def _layer_norm_weights(name: str, w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> None:
    _check_weight(name, w, x)
    _check_weight(name, b, x)
    if b.dtype != w.dtype:
        raise TypeError(f"{name} kernel takes a weight and a bias of one dtype")
    if x.shape[-1] > ADD_NORM_MAX_N:
        raise ValueError(f"{name} kernel holds rows of at most {ADD_NORM_MAX_N}, "
                         f"got {x.shape[-1]}")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (one launch on the card, a row's bits
    independent of the rows beside it)."""
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    x = _rows("layer_norm", x)
    _layer_norm_weights("layer_norm", scale, bias, x)
    out = torch.empty_like(x)
    N = x.shape[-1]
    if x.numel() == 0:
        return out
    err = build.library(LIBRARY).layer_norm_bf16(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // N, N,
        float(eps), int(scale.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layer_norm")
    layer_norm.launches += 1
    return out


def add_layer_norm(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + a, layer_norm(x + a, w, b)) in one launch; both outputs new
    tensors of x's shape."""
    if not x.is_cuda:
        return add_layer_norm_plain(x, a, w, b, eps)
    if a.shape != x.shape or a.device != x.device:
        raise ValueError(f"add_layer_norm kernel needs a {tuple(x.shape)} on x's device, "
                         f"got {tuple(a.shape)}")
    x, a = _rows("add_layer_norm", x), _rows("add_layer_norm", a)
    _layer_norm_weights("add_layer_norm", w, b, x)
    res, out = torch.empty_like(x), torch.empty_like(x)
    N = x.shape[-1]
    if x.numel():
        err = build.library(LIBRARY).add_layer_norm_bf16(
            x.data_ptr(), a.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(),
            out.data_ptr(), x.numel() // N, N, float(eps), int(w.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "add_layer_norm")
        add_layer_norm.launches += 1
    return res, out


layer_norm.launches = 0
add_layer_norm.launches = 0
