"""Rank functions of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py, tests/test_torch_cuda.py), run on each rank
by llm_inference_lab_tpu_torch.parallel.multihost.launch.

A spawned rank imports the module of the function it runs, so this module
imports the port and nothing of JAX or the JAX package: the tests build the
weights with the JAX package, carry them over (convert.params_from_jax) and
pass the port's trees in."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.core.multihost_batching import MultiHostBatcher
from llm_inference_lab_tpu_torch.models import llama
from llm_inference_lab_tpu_torch.models.base import KVCache, Model, ModelConfig
from llm_inference_lab_tpu_torch.parallel.mesh import make_mesh
from llm_inference_lab_tpu_torch.parallel.multihost import make_multihost_mesh
from llm_inference_lab_tpu_torch.parallel.sharding import shard_model

# JAX's multihost worker (scripts/multihost_worker.py): its prompts, the
# budgets of its plain and lazy runs and its per-mode engine settings.
MH_PROMPTS = [
    "multi host prompt alpha " * 3,
    "beta",
    "the third multi host prompt is a bit longer " * 2,
    "gamma delta",
    "epsilon " * 5,
    "zeta",
]
MH_MODES = {
    "contiguous": {},
    "paged": dict(kv_layout="paged", kv_page_size=32),
    "lazy": dict(kv_layout="paged", kv_page_size=32, kv_pages=10, max_new_tokens=48),
    "adaptive-device": dict(controller="adaptive-device"),
}


def mh_budgets(mode: str, max_new: int):
    return [max_new - 8 * (i % 2) if mode == "lazy" else 8 + 4 * (i % 3)
            for i in range(len(MH_PROMPTS))]


def mh_config(mode: str) -> dict:
    """The worker's EngineConfig fields of a mode (port names)."""
    over = dict(MH_MODES[mode])
    return dict(max_draft=3, max_new_tokens=over.pop("max_new_tokens", 16), dtype="float32",
                max_seq_len=256, shard_draft=True, base_model="mh-1", draft_model="mh-2",
                **over)


def register(configs: dict) -> None:
    """Test configs in the port's llama preset table (each rank's own)."""
    llama.LLAMA_CONFIGS.update(configs)


@torch.inference_mode()
def _forward(model: Model, tokens: np.ndarray, steps, device) -> list:
    """A prefill of tokens [B, P] and decode chunks of the given lengths,
    each continuing the cache; the f32 logits of each as numpy."""
    B, P = tokens.shape
    total = P + sum(steps)
    cache = model.init_cache(B, -(-total // 32) * 32, device)
    out, pos = [], 0
    ids = torch.from_numpy(tokens).to(device)
    chunks = [ids] + [torch.from_numpy((tokens[:, :s] + 7 * (i + 1)) % 256).to(device)
                      for i, s in enumerate(steps)]
    for chunk in chunks:
        S = chunk.shape[1]
        positions = (pos + torch.arange(S, dtype=torch.int32, device=device))[None].expand(B, S)
        lens = torch.full((B,), pos, dtype=torch.int32, device=device)
        logits, _ = model.forward(chunk.int(), positions.contiguous(), cache, lens)
        out.append(logits.float().cpu().numpy())
        pos += S
    return out


def tp_forward(cases: dict, tokens: np.ndarray, steps=(1, 3), device="cpu") -> dict:
    """Each case's (config, whole params) forward on this rank's share over
    a model axis of the whole world: case -> logits of the prefill and each
    decode chunk."""
    mesh = make_mesh(data=1, model=torch.distributed.get_world_size())
    out = {}
    for name, (cfg, params) in cases.items():
        params = _to(params, device)
        out[name] = _forward(shard_model(Model(cfg, params), mesh), tokens, steps, device)
    return out


def _to(tree, device):
    from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant, EmbedQuant4, QuantTensor

    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.data.to(device), tree.scale.to(device), tree.bits)
    if isinstance(tree, EmbedQuant):
        return EmbedQuant(tree.q.to(device), tree.scale.to(device))
    if isinstance(tree, EmbedQuant4):
        return EmbedQuant4(_to(tree.qt, device), tree.rq.to(device))
    return tree.to(device)


def engine_ids(configs: dict, cfg_kws: list, target_params, draft_params, prompts,
               mesh_shape: dict, seeds=(None,)) -> list:
    """Engine.generate_batch on a (data, model) mesh, an engine for each
    EngineConfig's fields: each seed's ids of every prompt, on this rank.
    An engine whose fields name a mesh_shape makes its own mesh from it;
    the others are given the mesh made here."""
    register(configs)
    mesh = make_mesh(**mesh_shape)
    out = []
    for kw in cfg_kws:
        eng = Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                     draft_params=draft_params, mesh=None if "mesh_shape" in kw else mesh)
        out.append({seed: [r["generated_ids"] for r in eng.generate_batch(prompts, seed=seed)]
                    for seed in seeds})
    return out


def refusals(configs: dict, cfg_kw: dict, target_params) -> dict:
    """The messages of what a mesh refuses, on a world of 4 ranks."""
    register(configs)
    out = {}

    def caught(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError, RuntimeError) as err:
            out[name] = f"{type(err).__name__}: {err}"

    from llm_inference_lab_tpu_torch.parallel.mesh import auto_mesh

    out["auto_mesh"] = auto_mesh().shape
    caught("stage_seq", lambda: make_mesh(stage=2, seq=2))
    caught("too_small", lambda: make_mesh(data=4, model=2))
    mesh = make_mesh(data=2, model=2)
    base = EngineConfig(**cfg_kw)
    caught("mesh_differs", lambda: Engine(EngineConfig(**dict(cfg_kw, mesh_shape={"model": 4})),
                                          device="cpu", target_params=target_params, mesh=mesh))
    seq_mesh, stage_mesh = make_mesh(seq=2, model=2), make_mesh(stage=2, model=2)
    # Built under seq and stage (they serve); paged KV under stage refuses.
    out["batcher_seq"] = type(ContinuousBatcher(
        Engine(base, device="cpu", target_params=target_params, mesh=seq_mesh),
        n_slots=2)).__name__
    out["multihost_stage"] = type(MultiHostBatcher(
        Engine(base, device="cpu", target_params=target_params, mesh=stage_mesh),
        n_slots=2)).__name__
    caught("stage_paged", lambda: Engine(EngineConfig(**dict(cfg_kw, kv_layout="paged")),
                                         device="cpu", target_params=target_params,
                                         mesh=stage_mesh))
    eng = Engine(base, device="cpu", target_params=target_params, mesh=mesh)
    caught("batcher_data", lambda: ContinuousBatcher(eng, n_slots=4))
    caught("slots_split", lambda: MultiHostBatcher(eng, n_slots=3))
    caught("batch_split", lambda: eng.generate_batch(["one", "two", "three"]))
    mh = MultiHostBatcher(eng, n_slots=4)
    if not mh.is_coordinator:
        caught("submit", lambda: mh.submit("x"))
        caught("cancel", lambda: mh.cancel(0))
    return out


def multihost_serve(configs: dict, target_params, draft_params, modes, model_per_host: int = 2,
                    device="cpu") -> dict:
    """JAX's worker workload through MultiHostBatcher in each mode: {mode:
    (results, stats)} (the other ranks' results are their placeholders'),
    and under "broadcast" what broadcast_from_rank0 gave this rank."""
    from llm_inference_lab_tpu_torch.parallel.multihost import broadcast_from_rank0

    register(configs)
    mesh = make_multihost_mesh(model_per_host=model_per_host)
    rank = torch.distributed.get_rank()
    out = {"broadcast": broadcast_from_rank0((np.full(3, rank, np.int32),
                                              np.arange(2.0) + rank))}
    for mode in modes:
        kw = mh_config(mode)
        eng = Engine(EngineConfig(**kw), device=device, target_params=_to(target_params, device),
                     draft_params=_to(draft_params, device), mesh=mesh)
        b = MultiHostBatcher(eng, n_slots=4)
        if b.is_coordinator:
            for prompt, budget in zip(MH_PROMPTS, mh_budgets(mode, kw["max_new_tokens"])):
                b.submit(prompt, max_new_tokens=budget)
        results = b.run()
        out[mode] = ([{k: r[k] for k in ("req_id", "generated_ids", "generated_tokens", "text")}
                      for r in results], b.stats.report(4))
    return out


def tp_batcher(configs: dict, target_params, draft_params, mode: str) -> list:
    """ContinuousBatcher on the model axis alone (every rank submits the
    same requests and makes the same host decisions): its results."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher

    register(configs)
    mesh = make_mesh(model=torch.distributed.get_world_size())
    kw = mh_config(mode)
    b = ContinuousBatcher(Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                                 draft_params=draft_params, mesh=mesh), n_slots=4)
    for prompt, budget in zip(MH_PROMPTS, mh_budgets(mode, kw["max_new_tokens"])):
        b.submit(prompt, max_new_tokens=budget)
    return [{k: r[k] for k in ("req_id", "generated_ids", "generated_tokens", "text")}
            for r in b.run()]


def tp_forward_cuda(cases: dict, tokens: np.ndarray) -> dict:
    """tp_forward on cuda:0 (the ranks share the card over gloo)."""
    torch.cuda.set_device(0)
    return tp_forward(cases, tokens, device="cuda")


def misbehave(kind: str, rank: int):
    """Rank `rank` raises, hangs or dies; the others return their rank."""
    if torch.distributed.get_rank() == rank:
        if kind == "raise":
            raise ValueError("this rank was told to fail")
        if kind == "hang":
            time.sleep(600)
        os._exit(3)
    return torch.distributed.get_rank()


def fake_build(root: str, delay: float) -> list:
    """build.build_all with a fake compiler (a script that writes its -o
    file slowly, in two writes) into root/_build: the libraries' paths and
    bytes as this rank sees them after the call."""
    from pathlib import Path

    from llm_inference_lab_tpu_torch import build

    build.BUILD_DIR = Path(root) / "_build"
    build.CSRC = Path(root) / "csrc"
    build._nvcc = lambda: os.path.join(root, "fake_nvcc")
    time.sleep(delay)
    build.build_all(["alpha", "beta"])
    return sorted((p.name, p.read_bytes()) for p in build.BUILD_DIR.glob("*.so"))


# ------------------------------------------------ the seq, stage and expert axes
def ring_attention(cases: dict, n: int) -> dict:
    """parallel/context.py ring_self_attention of each case's globally shaped
    (q, k, v, lengths) numpy arrays over a seq axis of the whole world: case
    -> the output on this rank (numpy)."""
    from llm_inference_lab_tpu_torch.parallel.context import ring_self_attention

    mesh = make_mesh(seq=n)
    out = {}
    for name, (q, k, v, lengths) in cases.items():
        t = [torch.from_numpy(np.asarray(a)) for a in (q, k, v)]
        lens = None if lengths is None else torch.from_numpy(np.asarray(lengths))
        out[name] = ring_self_attention(*t, mesh, lengths=lens).numpy()
    return out


def mesh_forward(cases: dict, tokens: np.ndarray, steps, mesh_shape: dict, cp: bool = False,
                 microbatches=None, device="cpu") -> dict:
    """Each case's (config, whole params) forward on this rank's share of a
    mesh of mesh_shape: a prefill of tokens [B, P] (with cp, the ring
    prefill over the seq axis) and decode chunks of the given lengths, each
    continuing the cache. case -> (logits of each chunk, this rank's cache
    k and its t0) as numpy; under a data axis each rank runs its block of
    the rows. device "cuda": the ranks share cuda:0."""
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh(**mesh_shape)
    out = {}
    for name, (cfg, params) in cases.items():
        model = shard_model(Model(cfg, _to(params, device)), mesh, microbatches)
        mine = tokens[mesh.data_slice(tokens.shape[0])]  # the data axis: this rank's rows
        B, P = mine.shape
        total = P + sum(steps)
        cache = model.init_cache(B, -(-total // 32) * 32, device)
        got, pos = [], 0
        chunks = [mine] + [(mine[:, :s] + 7 * (i + 1)) % 256 for i, s in enumerate(steps)]
        with torch.inference_mode():
            for i, chunk in enumerate(chunks):
                S = chunk.shape[1]
                positions = (pos + torch.arange(S, dtype=torch.int32, device=device))[None]
                lens = torch.full((B,), pos, dtype=torch.int32, device=device)
                logits, _ = model.forward(torch.from_numpy(chunk).int().to(device),
                                          positions.expand(B, S).contiguous(), cache, lens,
                                          cp=cp and i == 0)
                got.append(logits.float().cpu().numpy())
                pos += S
        out[name] = (got, cache.k.float().cpu().numpy(), cache.t0)
    return out


def mesh_engine_ids(configs: dict, cfg_kws: list, target_params, draft_params, prompts,
                    mesh_shape: dict) -> list:
    """Engine.generate_batch of each EngineConfig's fields on a mesh of
    mesh_shape (the engine's target and draft given whole): each engine's
    ids of every prompt, on this rank."""
    register(configs)
    mesh = make_mesh(**mesh_shape)
    out = []
    for kw in cfg_kws:
        eng = Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                     draft_params=draft_params, mesh=mesh)
        out.append([r["generated_ids"] for r in eng.generate_batch(prompts)])
    return out


def expert_moe(x, router, w_gate_up, w_down, top_k: int, mesh_shape: dict) -> np.ndarray:
    """ops/moe.py moe_expert of rows x on this rank's experts and columns of
    the whole stacks under a mesh of mesh_shape (expert, model)."""
    from llm_inference_lab_tpu_torch.ops.moe import moe_expert
    from llm_inference_lab_tpu_torch.parallel.sharding import shard_params

    mesh = make_mesh(**mesh_shape)
    E, D, F2 = w_gate_up.shape
    cfg = ModelConfig(name="moe-test", n_layers=1, n_heads=2 * mesh.shape["model"],
                      n_kv_heads=mesh.shape["model"], d_model=D, d_ff=F2 // 2, vocab_size=256,
                      n_experts=E, experts_per_token=top_k, dtype=torch.float32)
    full = {"layers": {"w_router": torch.from_numpy(np.asarray(router))[None],
                       "w_gate_up": torch.from_numpy(np.asarray(w_gate_up))[None],
                       "w_down": torch.from_numpy(np.asarray(w_down))[None]}}
    mine = shard_params(full, mesh, cfg)["layers"]
    y = moe_expert(torch.from_numpy(np.asarray(x)), mine["w_router"][0], mine["w_gate_up"][0],
                   mine["w_down"][0], top_k=top_k, ep=mesh.axis("expert"), tp=mesh.tp)
    return y.numpy()


def mesh_forward_runs(cases: dict, tokens: np.ndarray, steps, runs) -> list:
    """mesh_forward for each (mesh_shape, cp, microbatches) of runs, in one
    world: a list of their results on this rank."""
    return [mesh_forward(cases, tokens, steps, shape, cp, micro) for shape, cp, micro in runs]


def engine_prompts(configs: dict, pairs, target_params, mesh_shape: dict) -> list:
    """Engine.generate of each (EngineConfig fields, prompt) on a mesh of
    mesh_shape (the target given whole): the ids of each, on this rank."""
    register(configs)
    mesh = make_mesh(**mesh_shape)
    return [Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                   mesh=mesh).generate(prompt)["generated_ids"] for kw, prompt in pairs]


def batcher_ids(configs: dict, kw: dict, target_params, prompts, mesh_shape: dict,
                n_slots: int = 2) -> list:
    """A ContinuousBatcher over an Engine on a mesh of mesh_shape (every rank
    submits the same requests and runs them): each request's ids, in
    request order."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher

    register(configs)
    mesh = make_mesh(**mesh_shape) if mesh_shape else None
    b = ContinuousBatcher(Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                                 mesh=mesh), n_slots=n_slots)
    for prompt in prompts:
        b.submit(prompt)
    return [r["generated_ids"] for r in sorted(b.run(), key=lambda r: r["req_id"])]


# --------------- padded sizes, LoRA, the fake model, the profiler, MultiHostBatcher
def jobs(items) -> list:
    """Each (name of a function of this module, args) in order, on every rank
    of one world (each job makes its meshes, collectively): their results on
    this rank. One launch runs a test file's every multi-rank check."""
    return [globals()[name](*args) for name, args in items]


def lora_engine_ids(configs: dict, kw: dict, target_params, adapters, prompts,
                    mesh_shape: dict, names, requests=None) -> dict:
    """An Engine with LoRA adapters (models/lora.py Adapters) on a mesh of
    mesh_shape: generate_batch's ids of the prompts under each adapter name
    of `names` (None the base model) and, with requests ((prompt, budget,
    adapter) triples), a MultiHostBatcher's ids of each in request order."""
    register(configs)
    eng = Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                 mesh=make_mesh(**mesh_shape), lora_adapters=adapters)
    out = {"batch": {name: [r["generated_ids"] for r in eng.generate_batch(prompts,
                                                                            adapter=name)]
                     for name in names}}
    if requests is not None:
        b = MultiHostBatcher(eng, n_slots=4)
        if b.is_coordinator:
            for prompt, budget, name in requests:
                b.submit(prompt, max_new_tokens=budget, lora=name)
        out["served"] = [r["generated_ids"] for r in sorted(b.run(), key=lambda r: r["req_id"])]
    return out


def fake_and_profile(configs: dict, fake_kw: dict, prompts, profile_kw: dict, target_params,
                     draft_params, shapes) -> dict:
    """The fake engine's generate_batch ids on a (data 2, model 2) mesh, and
    for each mesh shape of `shapes` a profiled engine's generate_batch: its
    ids, the profiler's summary (phase_ms filled) and profile_phases()
    called again."""
    register(configs)
    fake = Engine(EngineConfig(**fake_kw), device="cpu", mesh=make_mesh(data=2, model=2))
    out = {"fake": [r["generated_ids"] for r in fake.generate_batch(prompts)],
           "fake_eager": fake.eager_loops}
    for shape in shapes:
        eng = Engine(EngineConfig(**profile_kw), device="cpu", target_params=target_params,
                     draft_params=draft_params, mesh=make_mesh(**shape))
        ids = [r["generated_ids"] for r in eng.generate_batch(prompts)]
        out["x".join(f"{k}{v}" for k, v in shape.items())] = (
            ids, eng.profiler.summary(), eng.profile_phases(), eng.eager_loops)
    return out


def mh_prefix_cancel(configs: dict, kw: dict, target_params, draft_params, requests,
                     cancel_reqs, mesh_shape: dict) -> dict:
    """MultiHostBatcher on a mesh of mesh_shape: (a) prefix-cached serving of
    (prompt, budget) requests, each result's ids, prompt tokens reused and
    slot; (b) the cancel_reqs through a batcher driven by hand: request 5
    cancelled while queued, then after the first chunk request 1 in flight;
    every result's ids and finish reason, and what cancel returned. (a)'s
    results also carry their token log-probs."""
    register(configs)
    mesh = make_mesh(**mesh_shape)
    n_slots = 2 * mesh.shape["data"]
    out = {}
    eng = Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                 draft_params=draft_params, mesh=mesh)
    b = MultiHostBatcher(eng, n_slots=n_slots)
    if b.is_coordinator:
        for prompt, budget in requests:
            b.submit(prompt, max_new_tokens=budget)
    out["prefix"] = [{k: r[k] for k in ("req_id", "generated_ids", "prompt_tokens_reused",
                                        "slot", "finish_reason", "token_logprobs")}
                     for r in sorted(b.run(), key=lambda r: r["req_id"])]
    b = MultiHostBatcher(Engine(EngineConfig(**dict(kw, prefix_caching=False)), device="cpu",
                                target_params=target_params, draft_params=draft_params,
                                mesh=mesh), n_slots=n_slots)
    said = []
    if b.is_coordinator:
        for prompt, budget in cancel_reqs:
            b.submit(prompt, max_new_tokens=budget)
        said.append(b.cancel(5))  # queued: four slots hold requests 0-3
    with torch.inference_mode():
        b._sync_poll()
        b.step_chunk(b.poll_every)
        b._retire_finished()
    if b.is_coordinator:
        said += [b.cancel(1), b.cancel(99)]  # in flight; never submitted
    out["cancel"] = [{k: r[k] for k in ("req_id", "generated_ids", "finish_reason")}
                     for r in sorted(b.run(), key=lambda r: r["req_id"])]
    out["said"] = said
    return out


def mh_expert(configs: dict, kw: dict, target_params, requests, mesh_shape: dict) -> list:
    """MultiHostBatcher on a mesh of mesh_shape (data x expert): each
    request's ids, in request order."""
    register(configs)
    b = MultiHostBatcher(Engine(EngineConfig(**kw), device="cpu", target_params=target_params,
                                mesh=make_mesh(**mesh_shape)), n_slots=4)
    if b.is_coordinator:
        for prompt, budget in requests:
            b.submit(prompt, max_new_tokens=budget)
    return [r["generated_ids"] for r in sorted(b.run(), key=lambda r: r["req_id"])]


# --------------- serving under the seq and stage axes
def _serve_by_hand(b, requests, cancel=None) -> list:
    """Drive a batcher one step a poll (admit, step_chunk(1), retire), as the
    parity tests drive JAX's; MultiHostBatcher through its own poll. cancel:
    (request, poll) cancelled by the coordinator before that poll. Returns
    each request's result, in request order."""
    multihost = isinstance(b, MultiHostBatcher) and b.n_procs > 1
    coordinator = not multihost or b.is_coordinator
    if coordinator:
        for prompt, budget in requests:
            b.submit(prompt, max_new_tokens=budget)
    with torch.inference_mode():
        for poll in range(400):
            if cancel is not None and poll == cancel[1] and coordinator:
                b.cancel(cancel[0])
            if multihost:
                info = b._sync_poll()
                if not any(s is not None for s in b._slots) and info["pending"] == 0:
                    break
            else:
                b._admit_pending()
                if not any(s is not None for s in b._slots) and not b.scheduler.pending():
                    break
            b.step_chunk(1)
            b._retire_finished()
    return [b._done[i].result for i in sorted(b._done)]


def serve_axes(configs: dict, cases: list) -> list:
    """Each case, a dict of kw (EngineConfig fields), shape (the mesh's),
    target and draft (whole params), requests ((prompt, budget) pairs),
    kind and cancel, on a mesh of its shape. kind "batcher": a
    ContinuousBatcher of 2 slots, "multihost": a MultiHostBatcher of 2
    slots a data row, each driven by _serve_by_hand (cancel: its
    (request, poll)), giving each result's ids, token log-probs, finish
    reason, prompt tokens reused, proposed and accepted, the stats'
    admitted and retired, and the target cache's k shape and t0 on this
    rank; "generate": Engine.generate's ids of each prompt. None on a rank
    outside the case's mesh."""
    register(configs)
    out = []
    for case in cases:
        mesh = make_mesh(**case["shape"])
        if mesh.coords is None:
            out.append(None)
            continue
        eng = Engine(EngineConfig(**case["kw"]), device="cpu", target_params=case["target"],
                     draft_params=case.get("draft"), mesh=mesh)
        if case["kind"] == "generate":
            out.append([eng.generate(prompt, max_new_tokens=budget)["generated_ids"]
                        for prompt, budget in case["requests"]])
            continue
        cls = MultiHostBatcher if case["kind"] == "multihost" else ContinuousBatcher
        b = cls(eng, n_slots=2 * mesh.shape["data"])
        got = _serve_by_hand(b, case["requests"], case.get("cancel"))
        cache = b.state.target_cache
        stats = b.stats.report(b.n_slots)
        out.append({"results": [{k: r[k] for k in SERVED_KEYS} for r in got],
                    "stats": (stats["admitted"], stats["retired"]),
                    "shape": tuple(cache.k.shape), "t0": getattr(cache, "t0", None)})
    return out


SERVED_KEYS = ("generated_ids", "token_logprobs", "finish_reason", "prompt_tokens_reused",
               "proposed", "accepted")


def compact_slices(seed: int, n: int) -> tuple:
    """core/treespec.py _compact on a cache split on T over a seq group of
    n ranks against _compact on the whole cache (made from seed on every
    rank): moves whose sources and destinations straddle the slices, an
    int8 cache with its scales. Returns (this rank's slice of the whole
    compaction, its own compaction of its slice): k, v and the scales."""
    from llm_inference_lab_tpu_torch.core.treespec import _compact

    g = torch.Generator().manual_seed(seed)
    L, B, KVH, T, D = 2, 3, 2, 8 * n, 4
    whole = KVCache(torch.randint(-127, 128, (L, B, KVH, T, D), generator=g).to(torch.int8),
                    torch.randint(-127, 128, (L, B, KVH, T, D), generator=g).to(torch.int8),
                    torch.rand((L, B, KVH, T), generator=g), torch.rand((L, B, KVH, T),
                                                                        generator=g))
    base = torch.tensor([5, 8 * n - 12, 2 * n + 3])[:, None]  # chunks across slice ends
    dst = base + 1 + torch.arange(4)[None]
    take_from = base + torch.tensor([[2, 4, 7, 9], [1, 3, 6, 10], [1, 2, 3, 4]])
    mesh = make_mesh(seq=n)
    per, r = T // n, mesh.coords["seq"]
    rows = slice(r * per, (r + 1) * per)
    mine = KVCache(*(t[:, :, :, rows].clone() for t in (whole.k, whole.v, whole.k_scale,
                                                         whole.v_scale)), t0=r * per)
    _compact(whole, take_from, dst)
    _compact(mine, take_from, dst, mesh.axis("seq"))
    return ([t[:, :, :, rows] for t in (whole.k, whole.v, whole.k_scale, whole.v_scale)],
            [mine.k, mine.v, mine.k_scale, mine.v_scale])
