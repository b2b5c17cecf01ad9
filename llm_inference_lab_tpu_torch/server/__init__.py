"""Serving layer: the OpenAI-compatible HTTP server over the continuous
batcher (port of llm_inference_lab_tpu/server)."""

from llm_inference_lab_tpu_torch.server.serving import InferenceServer  # noqa: F401
