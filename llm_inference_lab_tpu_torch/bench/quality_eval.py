"""Perplexity-based quality evaluation (port of
llm_inference_lab_tpu/bench/quality_eval.py).

exp(mean next-token NLL) of token ids under an eval model: one forward over
a fresh cache of S rows (``Model.forward``, f32 head logits), as JAX's
``_nll_fn``. On the card that forward runs kernel E (S > 32) and, for int4
or int8 weights, A's or B's tensor-core path (M = S >= 64); on the CPU their
plain versions. ``perplexity_delta`` is the quality gate between two
variants of one model (bf16 against ``quantized_clone``'s int8 or int4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.ops.quant import quantize_params


def _device_of(params: Any) -> torch.device:
    """The device of the params' first plain tensor (a norm scale: never
    quantized)."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return node.device
        if isinstance(node, dict):
            stack.extend(node.values())
    raise ValueError("the model's params hold no tensor")


def _copy_tree(node: Any) -> Any:
    """The nested dicts copied, the leaves shared (quantize_params replaces
    leaves in place)."""
    return {k: _copy_tree(v) for k, v in node.items()} if isinstance(node, dict) else node


def quantized_clone(model: Model, mode: str, min_size: int = 1024) -> Model:
    """The model with every weight leaf of min_size elements or more
    quantized to `mode` ("int8" or "int4"; JAX's quality tests' helper and
    min_size); the original's params are left as they are."""
    return dataclasses.replace(
        model, params=quantize_params(_copy_tree(model.params), mode, min_size=min_size))


class PerplexityEvaluator:
    def __init__(self, eval_model: Model, max_seq_len: int = 512):
        self.model = eval_model
        self.max_seq_len = max_seq_len
        self.device = _device_of(eval_model.params)

    @torch.inference_mode()
    def _nll(self, tokens: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """Mean next-token NLL over positions [1, length)."""
        B, S = tokens.shape
        dev = tokens.device
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S).contiguous()
        cache = self.model.init_cache(B, S, dev)
        logits, _ = self.model.forward(tokens, positions, cache,
                                       torch.zeros((B,), dtype=torch.int32, device=dev))
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = tokens[:, 1:].long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = (torch.arange(1, S, device=dev)[None, :] < length[:, None]).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def perplexity_ids(self, token_ids: List[int]) -> float:
        ids = token_ids[: self.max_seq_len]
        if len(ids) < 2:
            return float("nan")
        tokens = torch.tensor([ids], dtype=torch.int32, device=self.device)
        length = torch.tensor([len(ids)], dtype=torch.int32, device=self.device)
        return float(torch.exp(self._nll(tokens, length)))

    def perplexity(self, text: str, tokenizer) -> float:
        return self.perplexity_ids(tokenizer.encode(text))

    def compare(self, texts: List[str], tokenizer) -> Dict[str, Any]:
        """Per-text and mean perplexities."""
        ppls = [self.perplexity(t, tokenizer) for t in texts]
        valid = [p for p in ppls if p == p]
        return {
            "perplexities": ppls,
            "mean": sum(valid) / len(valid) if valid else float("nan"),
            "n": len(valid),
        }


def perplexity_delta(
    model_a: Model,
    model_b: Model,
    token_ids: List[List[int]],
    max_seq_len: int = 512,
) -> Dict[str, float]:
    """Quality gate between two variants of the same model (e.g. bf16 and
    int8): the mean perplexity of each and the delta."""
    ev_a = PerplexityEvaluator(model_a, max_seq_len)
    ev_b = PerplexityEvaluator(model_b, max_seq_len)
    pa = [ev_a.perplexity_ids(ids) for ids in token_ids]
    pb = [ev_b.perplexity_ids(ids) for ids in token_ids]
    ma = sum(pa) / len(pa)
    mb = sum(pb) / len(pb)
    return {"ppl_a": ma, "ppl_b": mb, "delta": mb - ma}
