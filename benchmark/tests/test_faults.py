"""A whole run with the timed path broken underneath, past the harness's
look for a card, comes out not correct: once for each fault its cell can
have.  Training: a step that returns its state unchanged; half of the
batch left out, the mean taken over the rest.  Serving: every served
token altered where it is produced; half of the rows left undecoded.
(One card a cell: no exchange between chips to leave out.)"""

import time

import pytest

from benchmark import run


@pytest.mark.parametrize("cell,fault", [("tiny.train", "unchanged"), ("tiny.train", "half_batch"),
                                        ("tiny.decode", "token"), ("tiny.decode", "half_batch")])
def test_fault_is_not_correct(tiny_root, cell, fault):
    result, numbers = run.run_cell(tiny_root, cell, 2**31 + 909, 0.1, False, device="cpu", fault=fault,
                                   t0=time.perf_counter())
    assert result["correct"] is False
    assert any(n["value"] > n["limit"] for n in numbers.values())
