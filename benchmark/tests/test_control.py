"""Each cell's control, the reference in the program's place at the next
precision down, comes out not correct; the program, at the same size, does
not.  Training's control takes fp8 matmul operands for bf16; serving's
judges, at each served position, the token that int4 weights put first,
for int8.  At this size the program runs in fp32 on the CPU, so the
limits are the tiny cells' (``conftest.TINY_LIMITS``)."""

import pytest

from benchmark.reference.compare import judge
from benchmark.control import readings

from .conftest import TINY_LIMITS

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["tiny.train", "tiny.decode"])
def test_control_is_not_correct(tiny_root, cell, seed):
    numbers = readings(tiny_root, cell, "control", seed, device="cpu")["control"]
    assert not judge(numbers, TINY_LIMITS[cell])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.decode"])
def test_program_is_correct_and_control_is_not_in_one_run(tiny_root, cell):
    numbers = readings(tiny_root, cell, "both", SEEDS[0], device="cpu")
    assert judge(numbers["program"], TINY_LIMITS[cell])
    assert not judge(numbers["control"], TINY_LIMITS[cell])
