"""BENCHMARK.json and the files it names: found by name, within the
contract's limits; no module of the benchmark imports JAX or the JAX
package, and the reference imports nothing of the program."""

import ast
import json
import re

import pytest

from rirbench import spec

ROOT = spec.ROOT
BENCH = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "rirbench.run"]
    assert BENCH["paths"] == ["rirbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c["chips"] == 1
    assert {"rx_err", "field_err", "branch_err"} <= set(c["limits"])
    for k in ("route", "sim_seconds", "receivers", "wall_margin_m"):
        assert k in c["traffic"]
    assert (ROOT / "rirbench" / "reference"
            / f"{c['config']['reference']}.py").is_file()
    assert {m["name"] for m in c["end_to_end"]} == {
        "mvps", "device_mem_gib", "setup_s"}
    assert c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    read = spec.reader(metric)
    run = {"trace": None, "spans": {"scene_s": 1.0, "engine_build_s": 1.0}}
    assert read(run) in (None, 1.0)


def test_names_units_and_entries():
    assert len(set(METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


SOURCES = sorted((ROOT / "rirbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "pffdtd_tpu"}


@pytest.mark.parametrize("path", sorted(
    (ROOT / "rirbench" / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "math", "numpy", "torch"}
