"""Parallelism over torch.distributed (port of
llm_inference_lab_tpu/parallel/): the mesh of the data, stage, expert, seq
and model axes (mesh.py), the sharding rules (sharding.py), ring attention
for the seq axis (context.py), the GPipe schedule of the stage axis
(pipeline.py; the expert axis's MoE is ops/moe.py moe_expert) and the
multi-process helpers and launcher (multihost.py)."""

from llm_inference_lab_tpu_torch.parallel.mesh import Mesh, auto_mesh, make_mesh  # noqa: F401
from llm_inference_lab_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_params,
    shard_state,
)
