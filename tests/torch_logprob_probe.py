"""Where the prompt-logprob gap between the port and the JAX package comes
from, on the batcher parity test's model (tests/test_torch_serving.py:
llama-tiny, weights x10, f32) and its six prompts. On the CPU, in seconds:

    JAX_PLATFORMS=cpu python tests/torch_logprob_probe.py

Prints, as maximum absolute differences of logits and prompt logprobs:
  1. the batch shape: each library's [G, P] admission-shaped prefill against
     its own B=1 forward over the unpadded prompt;
  2. the libraries: the port's B=1 forward against JAX's;
  3. f32 itself: each library against a float64 forward of the same weights
     (the port's forward with rope and attention computed in float64), and
     that float64 forward with one op's output rounded to f32;
  4. the port-JAX gap by |lp| range, and the largest attention score.
"""

import os
import sys
from dataclasses import replace

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_serving import COMMON, REQUESTS, _tiny  # noqa: E402

from llm_inference_lab_tpu.models.base import KVCache as JaxKVCache  # noqa: E402
from llm_inference_lab_tpu_torch.config import EngineConfig  # noqa: E402
from llm_inference_lab_tpu_torch.convert import params_from_jax  # noqa: E402
from llm_inference_lab_tpu_torch.core.engine import Engine  # noqa: E402
from llm_inference_lab_tpu_torch.models import transformer as T  # noqa: E402
from llm_inference_lab_tpu_torch.models.base import KVCache  # noqa: E402

target = _tiny(0)
eng = Engine(EngineConfig(**COMMON), device="cpu", target_params=params_from_jax(target.params))
CFG = eng.target.config
IDS = [eng.encode(p, m, COMMON["max_seq_len"]) for p, m in REQUESTS]


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if torch.is_tensor(tree) and tree.is_floating_point() else tree


def port(rows: np.ndarray, dtype=torch.float32) -> np.ndarray:
    G, P = rows.shape
    cfg = replace(CFG, dtype=dtype)
    with torch.inference_mode():
        lg, _ = T.forward(cfg, _cast(eng.target.params, dtype), torch.from_numpy(rows),
                          torch.arange(P, dtype=torch.int32)[None].repeat(G, 1),
                          KVCache.create(cfg, G, P, "cpu"), torch.zeros(G, dtype=torch.int32))
    return lg.double().numpy()


def jax_fwd(rows: np.ndarray) -> np.ndarray:
    G, P = rows.shape
    lg, _ = target.apply(target.params, jnp.asarray(rows),
                         jnp.tile(jnp.arange(P, dtype=jnp.int32)[None], (G, 1)),
                         JaxKVCache.create(target.config, G, P), jnp.zeros(G, jnp.int32))
    return np.asarray(lg, np.float64)


def logprobs(lg: np.ndarray, ids) -> np.ndarray:
    """Row i scores prompt token i+1, gather - logsumexp, in float64."""
    lg = lg[: len(ids) - 1]
    m = lg.max(-1, keepdims=True)
    lse = m[:, 0] + np.log(np.exp(lg - m).sum(-1))
    return np.take_along_axis(lg, np.asarray(ids[1:])[:, None], -1)[:, 0] - lse


def gap(a, b, ids):
    n = len(ids)
    return np.abs(a[:n] - b[:n]).max(), np.abs(logprobs(a, ids) - logprobs(b, ids)).max()


def one(ids):
    return np.asarray([ids], np.int32)


# --- float64 forward: rope and attention in float64 too -----------------
def _rope_tables64(cfg, positions):
    inv = torch.from_numpy(T._rope_inv_freq_np(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling))
    a = positions[..., None].double() * inv
    return torch.cos(a)[:, :, None, :], torch.sin(a)[:, :, None, :]


def _rope64(x, cos, sin):
    h = x.shape[-1] // 2
    x1, x2, cos, sin = x[..., :h], x[..., h:], cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


SCORES = []


def _attend64(q, k, v, positions, k_scale=None, v_scale=None, round_qk=False,
              round_scores=False, **options):
    """Causal attention from position 0 in q's dtype (prefill only), over a
    float cache; the model's attention options (llama-tiny: no window,
    ring, scale or softcap) are not read."""
    assert k_scale is None and v_scale is None, "an int8 cache is not probed"
    S, g = q.shape[1], q.shape[2] // k.shape[1]
    if round_qk:
        q, k = q.float().double(), k.float().double()
    kk, vv = (t[:, :, :S].repeat_interleave(g, 1) for t in (k, v))
    s = torch.einsum("bshd,bhtd->bhst", q, kk) * q.shape[-1] ** -0.5
    SCORES.append(float(s.abs().max()))
    if round_scores:
        s = s.float().double()
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -float("inf"))
    return torch.einsum("bhst,bhtd->bshd", s.softmax(-1), vv)


def float64_forward(rows, attend=_attend64, round_op=None):
    saved = {n: getattr(T, n)
             for n in ("rope_tables", "rope", "attend", "rms_norm", "add_rms_norm", "dense")}
    T.rope_tables, T.rope, T.attend = _rope_tables64, _rope64, attend
    if round_op is not None:
        f = saved[round_op]
        setattr(T, round_op, lambda *a: f(*a).float().double())
    if round_op == "rms_norm":  # the norms after the residual adds: their output, not the sum
        add = saved["add_rms_norm"]

        def add_rounded(*a, **k):
            x, n = add(*a, **k)
            return x, n.float().double()

        T.add_rms_norm = add_rounded
    try:
        return port(rows, torch.float64)
    finally:
        for n, f in saved.items():
            setattr(T, n, f)


def main():
    print("prompt lengths", [len(i) for i in IDS])
    print("1. batch shape: [G, P] admission prefill vs the same library's B=1 unpadded forward")
    for G, P in ((3, 256), (4, 64)):
        sel = [i for i in range(len(IDS)) if len(IDS[i]) <= P][:G]
        rows = np.zeros((len(sel), P), np.int32)
        for g, i in enumerate(sel):
            rows[g, : len(IDS[i])] = IDS[i]
        pg, jg = port(rows), jax_fwd(rows)
        worst = {"port": (0.0, 0.0), "jax": (0.0, 0.0)}
        for g, i in enumerate(sel):
            for name, batch, fwd in (("port", pg, port), ("jax", jg, jax_fwd)):
                d = gap(batch[g], fwd(one(IDS[i]))[0], IDS[i])
                worst[name] = tuple(max(x, y) for x, y in zip(worst[name], d))
        print(f"   G={len(sel)} P={P}: port logits {worst['port'][0]:.3g} lp {worst['port'][1]:.3g}"
              f"; jax logits {worst['jax'][0]:.3g} lp {worst['jax'][1]:.3g}")

    print("2-3. B=1 unpadded, per prompt: port vs jax; each vs the float64 forward")
    rows_lp, gaps_lp = [], []
    for ids in IDS:
        r = one(ids)
        p32, j32, ref = port(r)[0], jax_fwd(r)[0], float64_forward(r)[0]
        d_pj, d_p64, d_j64 = gap(p32, j32, ids), gap(p32, ref, ids), gap(j32, ref, ids)
        print(f"   n={len(ids):3d}: port-jax logits {d_pj[0]:.3g} lp {d_pj[1]:.3g}; "
              f"port-f64 lp {d_p64[1]:.3g}; jax-f64 lp {d_j64[1]:.3g}")
        rows_lp.append(logprobs(j32, ids))
        gaps_lp.append(np.abs(logprobs(p32, ids) - logprobs(j32, ids)))
    ids = max(IDS, key=len)
    r = one(ids)
    SCORES.clear()
    ref = float64_forward(r)[0]
    print(f"   largest |attention score| per layer (float64, n={len(ids)}):",
          [round(s, 1) for s in SCORES])
    print(f"   float64 forward with one op's output rounded to f32 (n={len(ids)}), lp vs float64:")
    for what, kw in (("attention scores",
                      dict(attend=lambda *a, **o: _attend64(*a, round_scores=True, **o))),
                     ("q and k", dict(attend=lambda *a, **o: _attend64(*a, round_qk=True, **o))),
                     ("rms_norm", dict(round_op="rms_norm")),
                     ("dense (every matmul)", dict(round_op="dense"))):
        print(f"     {what}: {gap(float64_forward(r, **kw)[0], ref, ids)[1]:.3g}")

    print("4. port-jax lp gap by |lp| (B=1, all prompt tokens)")
    lp, d = np.abs(np.concatenate(rows_lp)), np.concatenate(gaps_lp)
    for lo, hi in ((0, 3), (3, 6), (6, 12)):
        sel = (lp >= lo) & (lp < hi)
        if sel.any():
            print(f"   |lp| in [{lo}, {hi}): {sel.sum()} tokens, max gap {d[sel].max():.3g}")
    i = int(d.argmax())
    print(f"   largest gap {d[i]:.3g} at |lp| {lp[i]:.3g}: {d[i] / lp[i]:.3g} of |lp|; "
          f"largest gap / |lp| over all tokens {np.max(d / lp):.3g}")


if __name__ == "__main__":
    main()
