"""Medusa head training: distill multi-step prediction from the target.

Port of llm_inference_lab_tpu/core/head_training.py
(``collect_hidden_targets``, ``train_medusa_heads``,
``self_distill_medusa``). Head d, fed the hidden state that predicted token
t+1, learns token t+2+d of the target's own sequences: the quantity the
medusa and tree steps verify. Only the [H, D, D] projections train; the
target is frozen (its hidden states come from one forward without
gradients), and the head logits are the target's own head over
h @ proj[d], as the step computes them.

Plain autograd with ``torch.optim.Adam`` (optax.adam's defaults: betas
0.9 and 0.999, eps 1e-8) in place of optax. The head's gradient with
respect to its input is written out (``HeadLogits``): the card's head
computes f32 logits from bf16 inputs in one cuBLAS call that has no
derivative. A head through kernel A (a quantized untied head) raises: A has
no backward, as JAX's Pallas kernel has none.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, QuantTensor


def head_table(model: Model) -> torch.Tensor:
    """The head as one f32 table [V, D] (logits = x @ table^T before any
    softcap): the tied embedding (an int8 one times its row scales) or the
    untied bf16 head. Raises NotImplementedError for a head through kernel
    A, and for the fake model's head (not differentiable)."""
    cfg, params = model.config, model.params
    if cfg.arch == "fake":
        raise NotImplementedError("the fake model's head is a lookup: it has no gradient")
    if cfg.tie_word_embeddings:
        embed = params["embed"]
        if isinstance(embed, EmbedQuant):
            return embed.q.float() * embed.scale[:, None]
        return embed.float()
    if isinstance(params["lm_head"], QuantTensor):
        raise NotImplementedError("training through a quantized untied head: kernel A has no "
                                  "backward")
    return params["lm_head"].float().t()


class HeadLogits(torch.autograd.Function):
    """The model's head as the step runs it (Model.head: f32 logits), with
    the gradient d logits / d x = table (through Gemma-2's final softcap
    when the model has one), cast back to x's dtype as JAX's transpose of
    its head product is."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, model: Model, table: torch.Tensor):
        logits = model.head(x)
        ctx.save_for_backward(table, logits)
        ctx.cap, ctx.dtype = model.config.final_logit_softcap, x.dtype
        return logits

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        table, logits = ctx.saved_tensors
        if ctx.cap is not None:  # d (cap tanh(z / cap)) / dz = 1 - (logits / cap)^2
            grad = grad * (1.0 - (logits / ctx.cap) ** 2)
        gx = (grad.reshape(-1, grad.shape[-1]) @ table).reshape(*grad.shape[:-1], -1)
        return gx.to(ctx.dtype), None, None


def collect_hidden_targets(model: Model, token_seqs: torch.Tensor, num_heads: int,
                           max_cache: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """One target forward over token_seqs [N, T] (int32): (hidden [N, T', D]
    in the model dtype, targets [N, T', num_heads]) with T' = T - 1 -
    num_heads; targets[:, t, d] = token_seqs[:, t + 2 + d]."""
    N, T = token_seqs.shape
    dev = token_seqs.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(N, 1)
    cache = model.init_cache(N, max(T, max_cache), dev)
    with torch.no_grad():
        _, _, hidden = model.forward(token_seqs, positions, cache,
                                     torch.zeros((N,), dtype=torch.int32, device=dev),
                                     return_hidden=True)
    Tp = T - 1 - num_heads
    tgt = torch.stack([token_seqs[:, 2 + d: 2 + d + Tp] for d in range(num_heads)], dim=-1)
    return hidden[:, :Tp], tgt


def train_medusa_heads(target_model: Model, token_seqs, num_heads: int = 2, steps: int = 200,
                       lr: float = 1e-2, init_proj: Optional[torch.Tensor] = None,
                       seed: int = 0) -> Tuple[torch.Tensor, List[float]]:
    """Returns (medusa_proj [num_heads, D, D] f32, loss history): the loss
    (the mean over heads of each head's mean negative log-likelihood) at
    every steps // 10-th step and the last. init_proj defaults to identity
    projections. seed is JAX's argument (its initialisation draws nothing)."""
    with torch.inference_mode(False):  # autograd, whatever the caller's mode
        return _train(target_model, token_seqs, num_heads, steps, lr, init_proj)


def _train(target_model: Model, token_seqs, num_heads: int, steps: int, lr: float,
           init_proj: Optional[torch.Tensor]) -> Tuple[torch.Tensor, List[float]]:
    cfg = target_model.config
    D = cfg.d_model
    dev = target_model.params["final_norm_scale"].device
    table = head_table(target_model)
    seqs = torch.as_tensor(np.asarray(token_seqs), dtype=torch.int32, device=dev)
    hid, tgt = collect_hidden_targets(target_model, seqs, num_heads)
    hid = hid.float()
    tgt = tgt.long()
    proj0 = (init_proj.float() if init_proj is not None
             else torch.eye(D, dtype=torch.float32, device=dev).expand(num_heads, D, D))
    proj = proj0.detach().clone().to(dev).requires_grad_(True)
    opt = torch.optim.Adam([proj], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn():
        total = 0.0
        for d in range(num_heads):
            h = hid @ proj[d]
            logits = HeadLogits.apply(h.to(cfg.dtype), target_model, table).float()
            nll = -torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., d:d + 1])
            total = total + nll.mean()
        return total / num_heads

    history: List[float] = []
    with torch.enable_grad():
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            opt.step()
            if i % max(1, steps // 10) == 0 or i == steps - 1:
                history.append(float(loss.detach()))
    return proj.detach(), history


def self_distill_medusa(engine, seed_prompts: List[str], num_heads: Optional[int] = None,
                        tokens_per_prompt: int = 64, steps: int = 200,
                        lr: float = 1e-2) -> Tuple[torch.Tensor, List[float]]:
    """End to end: the target's greedy continuations of seed_prompts (a
    baseline engine on the engine's target weights, tokens_per_prompt new
    tokens), the heads trained on them from the engine's own, and the
    result written into the engine's heads in place (its steps and captured
    graphs read them), the first num_heads of them (all by default)."""
    from llm_inference_lab_tpu_torch.core.engine import Engine

    heads = engine._draft_params["medusa_proj"]
    num_heads = num_heads or heads.shape[0]
    base = Engine(replace(engine.config, draft_mode="vanilla", draft_model=None,
                          max_new_tokens=tokens_per_prompt),
                  device=engine.device, flags=engine.flags, target_params=engine.target.params)
    seqs = [engine.tokenizer.encode(p) + base.generate(p)["generated_ids"] for p in seed_prompts]
    T = min(len(s) for s in seqs)
    batch = np.stack([s[:T] for s in seqs]).astype(np.int32)
    proj, hist = train_medusa_heads(engine.target, batch, num_heads=num_heads, steps=steps, lr=lr,
                                    init_proj=heads[:num_heads].float())
    heads[:num_heads].copy_(proj.to(heads.dtype))
    return proj, hist
