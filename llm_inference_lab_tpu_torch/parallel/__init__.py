"""Tensor and data parallelism over torch.distributed (port of
llm_inference_lab_tpu/parallel/): the mesh (mesh.py), the sharding rules
(sharding.py) and the multi-process helpers and launcher (multihost.py).
The seq, stage and expert axes (JAX's context.py, pipeline.py and the
expert axis of ops/moe.py) are not ported: make_mesh refuses them."""

from llm_inference_lab_tpu_torch.parallel.mesh import Mesh, auto_mesh, make_mesh  # noqa: F401
from llm_inference_lab_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_params,
    shard_state,
)
