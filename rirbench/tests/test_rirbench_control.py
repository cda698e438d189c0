"""The control (the reference in TF32 in the program's place) fails the
cell's limits, here at a size a test can hold; on the card at the
cells' own sizes by `python -m rirbench.control` (PERF.md)."""

import pytest
import torch

from rirbench import control

CELLS = ["fcc_lossy_box.step", "cart_lossy_box.step", "fcc_lossy_box.tb"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name, tiny):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = tiny(name, seconds=0.03)
        got = control.control(cell, 2**33 + 3, "cpu")
    finally:
        torch.set_num_threads(n)
    over = [k for k, v in cell["limits"].items()
            if isinstance(v, dict) and got[k] > v["limit"]]
    assert over, got


def test_tf32_rounds_to_ten_mantissa_bits():
    from rirbench.reference.box_fdtd import tf32
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      -1.0 - 2.0**-12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -1.0])
    assert torch.equal(tf32(x.clone()), want)
