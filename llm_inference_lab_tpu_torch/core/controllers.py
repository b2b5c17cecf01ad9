"""K controllers: fixed and adaptive draft-length selection (a copy of
llm_inference_lab_tpu/core/controllers.py, which is pure Python).

``FixedKController`` keeps K. ``AdaptiveKController`` runs on the host
between steps: a sliding window of 32 acceptance rates, K += step when the
recent acceptance is above target + 0.1, K -= step when below target - 0.1,
within [min_k, max_k]; the engine steps one K at a time, each K its own
graph (core/engine.py). ``AdaptiveDeviceKController`` is the marker of the
device-side rule: an EMA of each lane's acceptance and the same hysteresis
inside the step (core/specstep.py ``adaptive_cfg``), so the decode loop
adapts K with no host read.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque


@dataclass
class FixedKController:
    k: int = 4

    def get_k(self, step: int = 0) -> int:
        return self.k

    def update(self, proposed: int, accepted: int) -> None:
        pass

    def info(self) -> dict:
        return {"type": "fixed", "k": self.k}


@dataclass
class AdaptiveKController:
    k: int = 4
    min_k: int = 1
    max_k: int = 8
    target_acceptance: float = 0.5
    window: int = 32
    step_size: int = 1
    _hist: Deque = field(default_factory=deque, repr=False)

    def get_k(self, step: int = 0) -> int:
        return self.k

    def update(self, proposed: int, accepted: int) -> None:
        if proposed <= 0:
            return
        self._hist.append(accepted / proposed)
        while len(self._hist) > self.window:
            self._hist.popleft()
        rate = sum(self._hist) / len(self._hist)
        if rate > self.target_acceptance + 0.1:
            self.k = min(self.k + self.step_size, self.max_k)
        elif rate < self.target_acceptance - 0.1:
            self.k = max(self.k - self.step_size, self.min_k)

    def info(self) -> dict:
        rate = sum(self._hist) / len(self._hist) if self._hist else None
        return {
            "type": "adaptive",
            "k": self.k,
            "min_k": self.min_k,
            "max_k": self.max_k,
            "target_acceptance": self.target_acceptance,
            "window": self.window,
            "recent_acceptance": rate,
        }


@dataclass
class AdaptiveDeviceKController:
    """Marker and settings of device-side adaptive K: the EMA and
    hysteresis update runs inside the spec step (core/specstep.py
    adaptive_cfg), so the decode loop's graph replays adapt K with no host
    read. The control rule of AdaptiveKController, per lane."""

    k: int = 4  # initial K (DecodeState.ctrl_k seed)
    min_k: int = 1
    max_k: int = 8
    target_acceptance: float = 0.5
    window: int = 32
    step_size: int = 1

    def get_k(self, step: int = 0) -> int:
        return self.k

    def update(self, proposed: int, accepted: int) -> None:
        pass  # adaptation happens on device

    def adaptive_cfg(self) -> dict:
        return {
            "min_k": self.min_k,
            "target_acceptance": self.target_acceptance,
            "window": self.window,
            "step_size": self.step_size,
        }

    def info(self) -> dict:
        return {
            "type": "adaptive-device",
            "k": self.k,
            "min_k": self.min_k,
            "max_k": self.max_k,
            "target_acceptance": self.target_acceptance,
            "window": self.window,
        }


def create_controller(name: str, k: int = 4, **params):
    if name == "fixed":
        return FixedKController(k=k)
    if name == "adaptive":
        return AdaptiveKController(k=k, **params)
    if name == "adaptive-device":
        return AdaptiveDeviceKController(k=k, **params)
    raise ValueError(
        f"unknown controller {name!r}; known: "
        "['fixed', 'adaptive', 'adaptive-device']"
    )
