"""Which op makes an int8 KV cache written step by step part from a fresh
prefill of the same tokens, on the int8 path of chip_smoke.py phase 4
(configs/llama32_int8.yaml with kv_quantization="int8", random weights from
seed 0, the phase-3 prompt). On a CUDA card, from the repo root:

    python3 tests/torch_kv_align_probe.py

Prints the first layer and position where the committed int8 keys of a
generate differ from a fresh prefill, then recomputes the layer before it
for that row twice, inside the verify chunk of 5 rows it was written by and
inside the fresh prefill's rows, and names each intermediate (norms,
projections, rope, attention, MLP) as equal or differing, with how many
values differ.
"""

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_inference_lab_tpu_torch.config import EngineConfig  # noqa: E402
from llm_inference_lab_tpu_torch.core.engine import Engine  # noqa: E402
from llm_inference_lab_tpu_torch.models import transformer as T  # noqa: E402
from llm_inference_lab_tpu_torch.models.base import cache_slots, write_cache_layer  # noqa: E402
from llm_inference_lab_tpu_torch.ops.attention import attend  # noqa: E402
from llm_inference_lab_tpu_torch.ops.quant import dense  # noqa: E402

PROMPT = "The quick brown fox jumps over the lazy dog. " * 3
CHUNK = 5  # the K=4 verify forward's rows


def layer(cfg, p, cache, i, x, pos, start):
    """One decoder layer on rows x [1, S, D] at positions pos, writing the
    cache at start; returns every intermediate."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = T.rope_tables(cfg, pos)
    out = {"attn_norm": T.rms_norm(x, p["attn_norm_scale"], cfg.rms_norm_eps)}
    out["qkv"] = dense(out["attn_norm"], p["w_qkv"])
    qk = T.rope(out["qkv"][..., :(H + KV) * Dh].reshape(B, S, H + KV, Dh), cos, sin)
    out["rope"] = qk
    v = out["qkv"][..., (H + KV) * Dh:].reshape(B, S, KV, Dh)
    write_cache_layer(cache, i, qk[:, :, H:], v, cache_slots(start, S, cache.max_seq_len))
    out["attention"] = attend(qk[:, :, :H].contiguous(), cache.k[i], cache.v[i], pos,
                              cache.k_scale[i], cache.v_scale[i])
    out["wo"] = dense(out["attention"].reshape(B, S, H * Dh), p["wo"])
    x1 = x + out["wo"]
    out["mlp_norm"] = T.rms_norm(x1, p["mlp_norm_scale"], cfg.rms_norm_eps)
    out["w_gate_up"] = dense(out["mlp_norm"], p["w_gate_up"])
    Fd = out["w_gate_up"].shape[-1] // 2
    out["silu * up"] = F.silu(out["w_gate_up"][..., :Fd]) * out["w_gate_up"][..., Fd:]
    out["w_down"] = dense(out["silu * up"], p["w_down"])
    out["layer out"] = x1 + out["w_down"]
    return out


@torch.inference_mode()
def main():
    dev = torch.device("cuda", 0)
    cfg = EngineConfig(base_model="llama-3.2-3b", draft_model="llama-3.2-1b", max_draft=4,
                       max_new_tokens=64, max_seq_len=512, quantization="int8",
                       quantized_init=True, kv_quantization="int8", seed=0)
    eng = Engine(cfg, device=dev)
    state, _, _, _ = eng.decode([PROMPT])
    live, tokens = state.target_cache, state.tokens
    n, Tn = int(state.lengths[0]) - 1, tokens.shape[1]
    model, mcfg = eng.target, eng.target.config
    fresh = model.init_cache(1, Tn, dev, dtype=torch.int8)
    pos = torch.arange(Tn, device=dev, dtype=torch.int32)[None]
    zero = torch.zeros((1,), device=dev, dtype=torch.int32)
    xs = [model.params["embed"][tokens].to(mcfg.dtype)]  # each layer's input, fresh run
    for i in range(mcfg.n_layers):
        xs.append(layer(mcfg, T._layer_params(model.params["layers"], i), fresh, i, xs[-1],
                        pos, zero)["layer out"])
    differ = (live.k[:, 0, :, :n] != fresh.k[:, 0, :, :n]).any(-1).any(1)  # [L, n]
    if not differ.any():
        print(f"the {n} committed rows of all {mcfg.n_layers} layers are equal")
        return
    first = int(differ.any(1).nonzero()[0])
    P = int(differ[first].nonzero()[0])
    print(f"first difference: layer {first}, position {P} "
          f"({int(differ[first].sum())} positions of that layer)")
    if first == 0:
        print("layer 0: the op is before the cache write (embedding, norm, w_qkv, rope)")
        return
    i = first - 1
    p = T._layer_params(model.params["layers"], i)
    full = layer(mcfg, p, model.init_cache(1, Tn, dev, dtype=torch.int8), i, xs[i], pos, zero)
    cache = model.init_cache(1, Tn, dev, dtype=torch.int8)
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(cache, name)[i, :, :, :P] = getattr(fresh, name)[i, :, :, :P]
    rows = torch.arange(P, P + CHUNK, device=dev, dtype=torch.int32)[None]
    chunk = layer(mcfg, p, cache, i, xs[i][:, P:P + CHUNK].contiguous(), rows,
                  torch.full((1,), P, device=dev, dtype=torch.int32))
    print(f"layer {i}, row {P}: computed in the {CHUNK}-row chunk against the {Tn}-row "
          f"prefill")
    for name in full:
        a, b = chunk[name][:, 0], full[name][:, P]
        nd = int((a != b).sum())
        print(f"  {name:12s} " + ("equal" if nd == 0 else
                                   f"{nd} of {a.numel()} values differ, largest "
                                   f"{float((a.float() - b.float()).abs().max()):.4g}"))


if __name__ == "__main__":
    main()
