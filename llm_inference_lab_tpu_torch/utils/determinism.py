"""Determinism helpers (port of llm_inference_lab_tpu/utils/determinism.py).

The port's decode is deterministic for a fixed seed without global state:
its sampling draws from a counter-based hash of the key in DecodeState.rng,
and every random init takes a seeded torch.Generator. What remains useful:
one place to seed the host's RNGs (python, numpy, torch) for host-side code
paths (shuffles, test data), a generator on the device where JAX returns
its PRNG key, and opt-in pinning of float32 matmul precision (no TF32), so
f32 products keep their rounding across cards and library versions.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from llm_inference_lab_tpu_torch import resolve_device


def ensure_deterministic(seed: int = 0, pin_matmul_precision: bool = False,
                         device="cuda") -> torch.Generator:
    """Seed python's, numpy's and torch's RNGs and return a torch.Generator
    on `device` seeded with `seed` (CUDA raises without a card). The pin
    turns TF32 off for float32 matmuls (JAX's
    jax_default_matmul_precision="highest")."""
    dev = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)  # for child processes, as JAX's
    if pin_matmul_precision:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return torch.Generator(device=dev).manual_seed(seed)


def set_deterministic_mode(enabled: bool = True, seed: int = 0, device="cuda"
                           ) -> torch.Generator:
    """JAX's switch (the reference's SPECDEC_DETERMINISTIC): seed everything
    when enabled; the seeded generator either way."""
    if enabled:
        return ensure_deterministic(seed, device=device)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
