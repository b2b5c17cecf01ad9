"""On the card: the generated ids of chip_smoke.py's paths, as digests, from
any checkout of the port, and kernel C and the norm pair timed in that
checkout; for holding a change to an earlier commit's ids and times.

    python3 tests/torch_ids_probe.py [<root>] [--time-only] [--sweep] [--e2e]

<root> is the directory that holds the checkout's llm_inference_lab_tpu_torch
(default: this repo), for example an earlier commit unpacked with
`git archive <commit> llm_inference_lab_tpu_torch | tar -x -C <root>` into a
git-ignored directory. The paths' settings, prompts and the digest come from
this repo's chip_smoke.py, so the lines "ids digest <path>: <digest>" read
as chip_smoke.py's do and can be compared with its run: the B=1 generate of
each configuration (int4, int8 with kv_alignment_report, Gemma-2 and its
long prompt, Mistral-7B on the ring and its long-prompt runs) and the paged
serving runs. First it times kernel C at every verify shape of the paths
(VERIFY_SHAPES) beside torch.argmax (--sweep: at each split plan of SWEEP,
for a checkout that has ops/verify.py's plan constants) and, at the main
path's K=1 step, the unfused norm pair (torch's add, then the rms_norm
kernel), with the host's enqueue time a call of the pair and, where the
checkout has it, of add_rms_norm; --e2e adds five timed B=1 generate calls
of the main path and the host's enqueue time of its draft and verify
forwards; --time-only stops there. Run it for two
checkouts in turns in one call (earlier, change, change, earlier) to compare
times.
"""

import importlib.util
import statistics
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_settings", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Kernel C's shapes on the paths, [B, K, V]: B=1 K=1 (int4, Gemma-2), K=4
# (int8, Mistral), the 8-slot serving steps (K=1 and K=4), and a 40-row
# Gemma-2 vocabulary.
VERIFY_SHAPES = [(1, 1, 128256), (1, 1, 256000), (1, 1, 32000), (1, 4, 128256), (1, 4, 32000),
                 (8, 1, 128256), (8, 1, 256000), (8, 4, 128256), (8, 5, 256000)]
SWEEP = [(bps, mn) for bps in (2, 4, 8, 16) for mn in (1024, 2048, 4096)]


def time_kernels(cs, dev, sweep):
    """Kernel C at VERIFY_SHAPES beside torch.argmax (with sweep, at every
    (BLOCKS_PER_SM, MIN_SPLIT) of SWEEP, each checked against the plain
    version), then the unfused norm pair at the main path's K=1 step."""
    from llm_inference_lab_tpu_torch.ops import rms_norm as rms_norm_module
    from llm_inference_lab_tpu_torch.ops import verify
    from llm_inference_lab_tpu_torch.ops.rms_norm import rms_norm

    g = torch.Generator(device=dev).manual_seed(3)
    data = []
    for B, K, V in VERIFY_SHAPES:
        lg = torch.randn((B, K + 1, V), generator=g, device=dev)[:, :-1]
        data.append((torch.argmax(lg, -1).to(torch.int32), lg))
    shapes = " ".join(f"[{B},{K},{V}]" for B, K, V in VERIFY_SHAPES)
    lib = [cs.median_ms(lambda: torch.argmax(lg, -1)) for _, lg in data]
    cs.log(f"time torch.argmax at {shapes}: " + " ".join(f"{t:.4f}" for t in lib))
    plans = SWEEP if sweep and hasattr(verify, "MIN_SPLIT") else [None]
    if plans[0] is not None:  # the checkout's own plan last, and kept after
        plans.append((verify.BLOCKS_PER_SM, verify.MIN_SPLIT))
    for plan in plans:
        if plan is not None:
            verify.BLOCKS_PER_SM, verify.MIN_SPLIT = plan
        times = []
        for d, lg in data:
            got, ref = verify.verify_prefix(d, lg), verify.verify_prefix_plain(d, lg)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), plan
            times.append(cs.median_ms(lambda: verify.verify_prefix(d, lg)))
        what = "" if plan is None else f" (BLOCKS_PER_SM, MIN_SPLIT) = {plan}"
        cs.log(f"time verify_prefix{what} at {shapes}: " + " ".join(f"{t:.4f}" for t in times))
    step = 0.0
    for M, N, n in ((1, 2048, 32), (2, 3072, 56)):
        x, a = (torch.randn((M, N), generator=g, device=dev).bfloat16() for _ in "xa")
        w = torch.ones((N,), device=dev, dtype=torch.bfloat16)
        ms = cs.median_ms(lambda: rms_norm(x + a, w, 1e-5))
        calls = {"torch add + rms_norm": lambda: rms_norm(x + a, w, 1e-5)}
        if hasattr(rms_norm_module, "add_rms_norm"):
            calls["add_rms_norm"] = lambda: rms_norm_module.add_rms_norm(x, a, w, 1e-5)
        host = {name: host_us(fn) for name, fn in calls.items()}
        cs.log(f"time torch add + rms_norm M={M} N={N}: {ms:.4f} ms; host enqueue a call: "
               + ", ".join(f"{name} {us:.2f} us" for name, us in host.items()))
        step += n * ms
    cs.log(f"time torch add + rms_norm, a K=1 step's 88 pairs: {step:.4f} ms")


def host_us(fn, n=2000):
    """Host microseconds to enqueue one call (median of 5 passes of n calls,
    each ended by a synchronize outside the timed loop)."""
    passes = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        passes.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(passes)


def end_to_end(cs, dev, runs=5):
    """The main path's B=1 generate (INT4_CFG): one warm-up, then runs
    timed calls; tok/s of each and their median."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    eng = Engine(EngineConfig(**cs.INT4_CFG), device=dev)
    eng.generate(cs.PROMPT)
    tps = [eng.generate(cs.PROMPT)["tokens_per_sec"] for _ in range(runs)]
    cs.log(f"e2e int4 K=1 B=1 tok/s: median {statistics.median(tps):.2f}, runs "
           f"{[round(t, 2) for t in tps]}")
    for name, model, S in (("1B draft", eng.draft, 1), ("3B verify", eng.target, 2)):
        host, wall = forward_ms(model, S, dev)
        cs.log(f"e2e {name} forward (B=1, S={S}, position 160): host enqueue {host:.3f} ms, "
               f"wall {wall:.3f} ms a forward (median of 5 passes of 50)")
    del eng
    torch.cuda.empty_cache()


def forward_ms(model, S, dev, n=50):
    """Host milliseconds to enqueue one forward of S rows at position 160 of
    a 256-slot cache, and wall milliseconds a forward once the device has
    finished (median of 5 passes of n forwards)."""
    cache = model.init_cache(1, 256, dev)
    tokens = torch.zeros((1, S), dtype=torch.int32, device=dev)
    positions = (160 + torch.arange(S, dtype=torch.int32, device=dev))[None]
    lens = torch.tensor([160], dtype=torch.int32, device=dev)
    model.forward(tokens, positions, cache, lens)
    host, wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model.forward(tokens, positions, cache, lens)
        host.append((time.perf_counter() - t0) / n * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / n * 1e3)
    return statistics.median(host), statistics.median(wall)


def serve_digest(cs, dev, eng, max_len, path):
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = replace(eng.config, max_seq_len=max_len, kv_layout="paged", kv_page_size=cs.SERVE_PAGE)
    b = ContinuousBatcher(Engine(cfg, device=dev, target_params=eng.target.params,
                                 draft_params=eng.draft.params), n_slots=cs.SERVE_SLOTS)
    for prompt, budget in zip(cs.SERVE_PROMPTS, cs.SERVE_BUDGETS):
        b.submit(prompt, max_new_tokens=budget)
    results = sorted(b.run(), key=lambda r: r["req_id"])
    cs.ids_digest(path, [r["generated_ids"] for r in results])


def ids(cs, dev):
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    paths = list(cs.PATH_KERNELS)
    for cfg, (gen, serve), max_len in ((cs.INT4_CFG, paths[0:2], cs.SERVE_MAX_LEN),
                                       (cs.INT8_CFG, paths[2:4], cs.INT8_MAX_LEN),
                                       (cs.GEMMA_CFG, (paths[4], paths[6]), cs.SERVE_MAX_LEN)):
        eng = Engine(EngineConfig(**cfg), device=dev)
        cs.ids_digest(gen, [eng.generate(cs.PROMPT)["generated_ids"]])
        if cfg is cs.INT8_CFG:
            cs.phase_kv_alignment(eng)
        if cfg is cs.GEMMA_CFG:
            base = Engine(replace(eng.config, draft_model=None), device=dev,
                          target_params=eng.target.params)
            cs.ids_digest(paths[5], [eng.generate(cs.LONG_PROMPT)["generated_ids"],
                                     base.generate(cs.LONG_PROMPT)["generated_ids"]])
            del base
        serve_digest(cs, dev, eng, max_len, serve)
        del eng
        torch.cuda.empty_cache()
    eng = Engine(EngineConfig(**cs.MISTRAL_CFG), device=dev)
    cs.ids_digest(paths[7], [eng.generate(cs.PROMPT)["generated_ids"]])
    tp = eng.target.params

    def baseline(**kw):
        e = Engine(replace(eng.config, draft_model=None, **kw), device=dev, target_params=tp)
        return e.generate(cs.MISTRAL_LONG)["generated_ids"]

    cs.ids_digest(paths[8], [eng.generate(cs.MISTRAL_LONG)["generated_ids"], baseline()])
    cs.ids_digest(paths[9], [baseline(kv_ring=False)])
    cs.ids_digest(paths[10], [baseline(kv_quantization="int8")])
    cs.ids_digest(paths[11], [baseline(kv_quantization="int8", kv_ring=False)])


def main(argv):
    if not torch.cuda.is_available():
        print("torch_ids_probe: needs a CUDA card", file=sys.stderr)
        return 2
    args = [a for a in argv if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else REPO
    sys.path.insert(0, str(root))
    cs = load_chip_smoke()
    import llm_inference_lab_tpu_torch as pkg

    assert Path(pkg.__file__).resolve().parent.parent == root, (pkg.__file__, root)
    cs.log(f"torch_ids_probe: the port from {root}")
    dev = torch.device("cuda", 0)
    time_kernels(cs, dev, "--sweep" in argv)
    if "--e2e" in argv:
        end_to_end(cs, dev)
    if "--time-only" not in argv:
        ids(cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
