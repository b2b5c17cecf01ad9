"""PyTorch/CUDA port of llm_inference_lab_tpu for one NVIDIA H100.

Module names follow the JAX package so each counterpart is easy to find.
Plain tensor code is PyTorch; the three TPU kernels of the speculative-decode
main path (int4 quant_matmul, flash_decode, verify_prefix) are CUDA C++ for
sm_90a under ``csrc/``, built with nvcc at first use.

Dispatch is by the tensor's device: a CPU tensor runs the op's plain PyTorch
version, a CUDA tensor launches the kernel or raises. Nothing falls back.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a machine without
    it raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
