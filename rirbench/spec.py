"""Finds a cell's files by the names in BENCHMARK.json.

A cell (`workloads` entry) names its configuration and its traffic; each
is a file of its own, found by name:

    rirbench/configs/<config>.json    the room and the scheme
    rirbench/traffic/<traffic>.json   the requests: route, duration, inputs
    rirbench/limits/<cell>.json       the limits of the numbers compared
    rirbench/metrics/<metric>.py      one reader per per-layer metric
    rirbench/reference/<name>.py      the plain reference a config names

so that a later cell, configuration or metric is added by adding files and
entries, without editing any file that is there."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(
        f"rirbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those that list it, and those with no `workloads` key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(cell: str, root: Path = ROOT) -> dict:
    """Everything one run of `cell` needs, from the files its names give;
    KeyError for a cell BENCHMARK.json does not have."""
    bench = manifest(root)
    w = {x["name"]: x for x in bench["workloads"]}
    if cell not in w:
        raise KeyError(f"cell {cell!r}: BENCHMARK.json has "
                       f"{sorted(w)}")
    entry = w[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    cfg = _json(root / cfg_entry["file"])
    return {
        "cell": cell,
        "chips": int(entry["chips"]),
        "config": cfg,
        "traffic": _json(PKG / "traffic" / f"{entry['traffic']}.json"),
        "limits": _json(PKG / "limits" / f"{cell}.json"),
        "end_to_end": cell_metrics(bench, cell, "end_to_end"),
        "per_layer": cell_metrics(bench, cell, "per_layer"),
    }


def reader(metric: str):
    """The per-layer metric's reader: `read(run) -> float | None`."""
    return load_module(PKG / "metrics" / f"{metric}.py").read


def spacing(cfg: dict) -> float:
    """The grid spacing h (m) the configuration states: c / (fmax ppw)."""
    return float(cfg["c"]) / (float(cfg["fmax_hz"]) * float(cfg["ppw"]))


def reference(cfg: dict):
    """The plain reference module the configuration names."""
    return load_module(PKG / "reference" / f"{cfg['reference']}.py")
