"""Admission order for continuous batching: length buckets with a max_wait
overdue rule.

Port of llm_inference_lab_tpu/native/__init__.py ``NativeScheduler``
(``submit``, ``pending``, ``admit``, ``record_step``, ``acceptance_ema``
and ``k``: the algorithm of its Python path and of native/scheduler.cc). The
JAX package kept a C++ copy for its TPU host; here it is host Python only:
one admission decision costs microseconds against a decode step of tens of
milliseconds.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

LENGTH_BUCKET = 32  # prompt lengths per bucket
MAX_WAIT = 64  # admission rounds a request may wait before it is overdue


class Scheduler:
    """Queued requests are admitted in waves. Each wave takes the prompt-
    length bucket (prompt_len // length_bucket) that holds the most queued
    requests, so a group prefills at similar lengths; a request that has
    waited more than max_wait admission rounds is overdue and goes first,
    with its own bucket, so none starves."""

    def __init__(self, length_bucket: int = LENGTH_BUCKET, max_wait: int = MAX_WAIT,
                 init_k: int = 4, min_k: int = 1, max_k: int = 8,
                 target_acceptance: float = 0.5, window: int = 32):
        self.length_bucket = length_bucket
        self.max_wait = max_wait
        # The serving path's adaptive K: an EMA of the acceptance rate with
        # alpha = 2 / (window + 1), from 0.5; K steps up by one above
        # target + 0.1 and down by one below target - 0.1, within [min_k,
        # max_k].
        self.min_k, self.max_k = min_k, max_k
        self.target_acceptance = target_acceptance
        self._alpha = 2.0 / (window + 1.0)
        self._ema = 0.5
        self._k = init_k
        # (req_id, prompt_len, submit order, admission round at submit)
        self._queue: Deque[Tuple[int, int, int, int]] = deque()
        self._seq = 0
        self._round = 0

    def submit(self, req_id: int, prompt_len: int, max_new: int) -> None:
        """Queue a request; max_new is taken for the JAX signature and not
        read by the ordering. The batcher requeues a request (pages it could
        not get, a preemption, a ring admission that must wait) by
        submitting its id again, at the back, as JAX's batcher does."""
        self._queue.append((req_id, prompt_len, self._seq, self._round))
        self._seq += 1

    def pending(self) -> int:
        return len(self._queue)

    def admit(self, n_slots: int) -> List[int]:
        """Up to n_slots request ids, in admission order."""
        width, max_wait = self.length_bucket, self.max_wait
        out: List[int] = []
        self._round += 1
        while len(out) < n_slots and self._queue:
            if (self._round - self._queue[0][3]) > max_wait:
                bucket = self._queue[0][1] // width
            else:
                counts: dict = {}
                for _, plen, _seq, _rnd in self._queue:
                    counts[plen // width] = counts.get(plen // width, 0) + 1
                bucket = max(sorted(counts), key=lambda b: counts[b])
            keep: Deque[Tuple[int, int, int, int]] = deque()
            for item in self._queue:
                same = (item[1] // width) == bucket
                overdue = (self._round - item[3]) > max_wait
                if len(out) < n_slots and (same or overdue):
                    out.append(item[0])
                else:
                    keep.append(item)
            self._queue = keep
        return out

    def record_step(self, proposed: int, accepted: int) -> int:
        """Feed one poll's proposed and accepted draft counts; returns K."""
        if proposed > 0:
            self._ema += self._alpha * (accepted / proposed - self._ema)
            if self._ema > self.target_acceptance + 0.1 and self._k < self.max_k:
                self._k += 1
            elif self._ema < self.target_acceptance - 0.1 and self._k > self.min_k:
                self._k -= 1
        return self._k

    @property
    def acceptance_ema(self) -> float:
        return self._ema

    @property
    def k(self) -> int:
        return self._k
