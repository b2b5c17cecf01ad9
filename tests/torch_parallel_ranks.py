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
    from llm_inference_lab_tpu_torch.models.lora import make_adapter

    register(configs)
    out = {}

    def caught(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError, RuntimeError) as err:
            out[name] = f"{type(err).__name__}: {err}"

    from llm_inference_lab_tpu_torch.parallel.mesh import auto_mesh

    out["auto_mesh"] = auto_mesh().shape
    for axis in ("seq", "stage", "expert"):
        caught(axis, lambda axis=axis: make_mesh(model=2, **{axis: 2}))
    caught("too_small", lambda: make_mesh(data=4, model=2))
    mesh = make_mesh(data=2, model=2)
    base = EngineConfig(**cfg_kw)
    tcfg = configs[base.base_model]
    caught("lora", lambda: Engine(base, device="cpu", target_params=target_params, mesh=mesh,
                                  lora_adapters=[make_adapter(tcfg, "a", rank=2)]))
    caught("profile", lambda: Engine(EngineConfig(**dict(cfg_kw, profile=True)), device="cpu",
                                     target_params=target_params, mesh=mesh))
    caught("mesh_differs", lambda: Engine(EngineConfig(**dict(cfg_kw, mesh_shape={"model": 4})),
                                          device="cpu", target_params=target_params, mesh=mesh))
    caught("fake", lambda: Engine(EngineConfig(implementation="fake", base_model="fake",
                                               draft_model="fake"), device="cpu", mesh=mesh))
    caught("moe", lambda: Engine(EngineConfig(base_model="mixtral-tiny", draft_model=None,
                                              dtype="float32"), device="cpu", mesh=mesh))
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher

    eng = Engine(base, device="cpu", target_params=target_params, mesh=mesh)
    caught("batcher_data", lambda: ContinuousBatcher(eng, n_slots=4))
    caught("slots_split", lambda: MultiHostBatcher(eng, n_slots=3))
    caught("batch_split", lambda: eng.generate_batch(["one", "two", "three"]))
    mh = MultiHostBatcher(eng, n_slots=4)
    caught("cancel", lambda: mh.cancel(0))
    if not mh.is_coordinator:
        caught("submit", lambda: mh.submit("x"))
    caught("prefix", lambda: MultiHostBatcher(Engine(
        EngineConfig(**dict(cfg_kw, kv_layout="paged", kv_page_size=32, prefix_caching=True)),
        device="cpu", target_params=target_params, mesh=mesh), n_slots=4))
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
