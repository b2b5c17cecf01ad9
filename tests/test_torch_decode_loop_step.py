"""The in-place step on the CPU against the functional step, bit for bit
(core/specstep.py's in-place step, which the decode loop replays): the
llama-tiny and mistral-tiny cases. The gemma2-tiny cases are in
test_torch_decode_loop_step_gemma.py; the weights and helpers come from
test_torch_decode_loop.py.
"""

import pytest
import torch

from llm_inference_lab_tpu_torch.core.state import FIELDS, assign, state_tensors
from test_torch_decode_loop import (CACHES, PROMPTS, _assert_same_tensors, _config, _engine,
                                    _fields, one_thread)  # noqa: F401

STEP_CASES = [("llama-tiny", "contiguous"), ("llama-tiny", "paged"), ("llama-tiny", "int8"),
              ("mistral-tiny", "ring"), ("mistral-tiny", "ring int8")]


def check_in_place_step(name, cache, k):
    """Two prompts prefilled alike, then the functional step on one copy of
    the state and the in-place step on another, until both lanes finished
    and two steps beyond: every field and every cache tensor is equal bit for
    bit after each step, the in-place step keeps the state's own tensors,
    and a step after every lane finished changes no field (steps included).
    K = 1 and 4 and the baseline (k None), over a contiguous, a paged (page
    16) and an int8 cache, and mistral-tiny's ring (128 slots, which the
    119-token prompt's decode wraps), bf16 and int8."""
    eng = _engine(_config(name, k, max_new_tokens=8, **CACHES[cache]))
    block, plens, max_len = eng._prompt_block(PROMPTS)
    prompt = torch.from_numpy(block), torch.from_numpy(plens)
    functional = eng._prefill(eng._init_state(len(plens), max_len), *prompt)
    in_place = eng._init_state(len(plens), max_len)  # prefilled as Engine.decode does
    assign(in_place, eng._prefill(in_place, *prompt))
    own = state_tensors(in_place)
    finished = 0
    for _ in range(eng.config.max_new_tokens + 2):
        before = _fields(in_place)
        functional = eng._step(functional)
        assert eng._step_in_place(in_place) is in_place
        assert all(a is b for a, b in zip(own, state_tensors(in_place)))
        _assert_same_tensors(functional, in_place)
        if not before["active"].any():
            finished += 1
            assert all(torch.equal(before[n], getattr(in_place, n)) for n in FIELDS)
    assert finished >= 2
    assert int(in_place.steps) < eng.config.max_new_tokens + 2


@pytest.mark.parametrize("k", [1, 4, None])
@pytest.mark.parametrize("name,cache", STEP_CASES)
def test_in_place_step_equals_functional_step(name, cache, k):
    """check_in_place_step at K = 1 and 4 and the baseline (k None)."""
    check_in_place_step(name, cache, k)
