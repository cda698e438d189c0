"""On the card: a run of each cell on a small room through the kernels,
traced, is correct and reads every per-layer metric of its cell.

    python3 -m pytest rirbench/tests -m cuda"""

import pytest

from rirbench import run

CELLS = ["fcc_lossy_box.step", "cart_lossy_box.step", "fcc_lossy_box.tb"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_room_on_the_card(name, tiny, card):
    cell = tiny(name, room=(6.0, 5.0, 4.0), h=0.05, seconds=0.02)
    out = run.run_cell(cell, 2**33 + 7, 0.5, True, card)
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    want = {m["name"] for m in cell["per_layer"]}
    assert set(out["metrics"]) == want
    for k, v in out["metrics"].items():
        if k.endswith("_roofline"):
            assert 0 < v["value"] <= 105, (k, v)
