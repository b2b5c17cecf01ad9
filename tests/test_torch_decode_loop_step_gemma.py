"""The in-place step on the CPU against the functional step, bit for bit:
the gemma2-tiny cases of test_torch_decode_loop_step.py (a file of their
own, so that no file holds a worker for long).
"""

import pytest

from test_torch_decode_loop import one_thread  # noqa: F401
from test_torch_decode_loop_step import check_in_place_step

STEP_CASES = [("gemma2-tiny", "contiguous"), ("gemma2-tiny", "paged")]


@pytest.mark.parametrize("k", [1, 4, None])
@pytest.mark.parametrize("name,cache", STEP_CASES)
def test_in_place_step_equals_functional_step(name, cache, k):
    """check_in_place_step at K = 1 and 4 and the baseline (k None)."""
    check_in_place_step(name, cache, k)
