"""The benchmark's tests: `python -m pytest rirbench/tests` from the
repository's root (on the card: `python3 -m pytest rirbench/tests -m
cuda`)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where CUDA is absent)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return "cuda"


def tiny_cell(name, precision="float32", room=(2.6, 2.1, 1.7), h=0.1,
              seconds=0.01):
    """`name`'s cell on a small room (the same scheme, walls and
    traffic), for runs on the CPU.  A cell `<config>.<traffic>` that
    BENCHMARK.json does not list yet (PERF.md §7's planned cells) is
    made from the files of its configuration and traffic, with the limits
    of the benchmark's first cell and the per-layer metrics that name no
    cells."""
    import json
    from rirbench import spec
    try:
        cell = spec.load_cell(name)
    except KeyError:
        bench = spec.manifest()
        config, traffic = name.split(".")
        cell = spec.load_cell(bench["workloads"][0]["name"])
        cell.update(
            cell=name,
            config=json.loads(
                (spec.PKG / "configs" / f"{config}.json").read_text()),
            traffic=json.loads(
                (spec.PKG / "traffic" / f"{traffic}.json").read_text()),
            per_layer=spec.cell_metrics(bench, name, "per_layer"))
    cfg = copy.deepcopy(cell["config"])
    cfg["room"] = dict(zip(("Lx", "Ly", "Lz"), room))
    cfg["fmax_hz"] = cfg["c"] / (cfg["ppw"] * h)
    cfg["precision"] = precision
    cell["config"] = cfg
    cell["traffic"] = dict(cell["traffic"], sim_seconds=seconds,
                           wall_margin_m=0.4, source_jitter_m=0.2)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
