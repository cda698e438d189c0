"""The readers of the program's spans (`rirbench/spans.py` and its nine
metrics) on hand-made stores, and on the store of a small room's set-up
and runs on the CPU."""

import sys
import time

import pytest
import torch

import pffdtd_tpu_torch
from pffdtd_tpu_torch import spans as pspans
from pffdtd_tpu_torch.spans import Span
from rirbench import program, spec

GIB = 2**30
MB = 2**20
NEW = ["engine_static_gib", "run_state_gib", "run_held_gib", "run_host_ms",
       "scene_box_s", "scene_rotate_s", "engine_data_s", "engine_upload_s"]
TRACED = {"trace": {"window_s": 1.0, "busy_s": 1.0}}
S = 10**9    # ns a second


def _set(name, t0, secs, parent=None):
    return Span(name, parent, None, t0, t0 + int(secs * S), 0)


def _run(k, t0, host, loop, mem_in, held, state, peak):
    """The three spans of run k: signals, state (allocating `state` bytes
    beside the `held` ones of `mem_in`, then freeing those; `peak` the
    process's peak before), a step loop of `loop` s, receivers; `host` s
    each."""
    a = t0
    b = a + int(host * S)
    c = b + int(host * S)
    d = c + int(loop * S)
    return [Span("run.signals", None, k, a, b, 0),
            Span("run.state", None, k, b, c, 0, mem_in,
                 mem_in + state - held, max(peak, mem_in + state)),
            Span("run.receivers", None, k, d, d + int(host * S), 0)]


def _store(tb=False, mem=True):
    """A process of the step cell: the scene, the engine (2 GiB uploaded
    over a 1 MiB context), two warm runs of a few steps, two of the
    window; each run allocates a 12.5 GiB state beside the last one's,
    then frees the last one's."""
    ctx, static, state = MB, 2 * GIB, int(12.5 * GIB)
    recs = [_set("comms.prepare", 0, 0.5, "scene.box"),
            Span("scene.box", None, None, 0, 9 * S, S // 2),
            _set("comms.prepare", 9 * S, 0.01),
            _set("scene.rotate", 10 * S, 2.0),
            _set("engine.data", 12 * S, 2.5),
            Span("engine.upload", None, None, 15 * S, 16 * S, 0,
                 ctx, ctx + static, ctx + static)]
    if tb:
        recs.append(Span("engine.tb_scene", None, None, 16 * S, 17 * S, 0,
                         ctx + static, ctx + static + GIB,
                         ctx + static + GIB))
        static += GIB
    held, peak = 0, ctx + static
    t = 20 * S
    for k, (host, loop) in enumerate([(0.004, 0.01), (0.004, 0.01),
                                      (0.003, 18.0), (0.005, 18.3)], 1):
        recs += _run(k, t, host, loop, ctx + static + held, held, state,
                     peak)
        held, peak, t = state, recs[-2].mem_peak, t + 20 * S
    if not mem:
        recs = [r._replace(mem_in=None, mem_out=None, mem_peak=None)
                for r in recs]
    return recs


def _read(run):
    return {m: spec.reader(m)(run) for m in NEW}


def test_new_metrics_are_appended_with_their_cell():
    """Each span metric is listed, with the step cell among its cells;
    later entries and cells may come beside them."""
    listed = {m["name"]: m for m in spec.manifest()["per_layer"]}
    for name in NEW:
        assert name in listed
        assert "fcc_lossy_box.step" in listed[name]["workloads"]
    cell = spec.load_cell("fcc_lossy_box.step")
    assert set(NEW) <= {m["name"] for m in cell["per_layer"]}


@pytest.mark.parametrize("tb", [False, True])
def test_tb_scene_seconds_on_a_hand_made_store(monkeypatch, tb):
    """engine_tb_scene_s reads the engine.tb_scene span (1 s in the tb
    store), and nothing where the engine built no tile lists."""
    monkeypatch.setattr(pspans, "records", lambda: _store(tb))
    v = spec.reader("engine_tb_scene_s")(TRACED)
    assert v == (pytest.approx(1.0) if tb else None)
    assert spec.reader("engine_tb_scene_s")({"trace": None}) is None


@pytest.mark.parametrize("tb", [False, True])
def test_readers_on_a_hand_made_store(monkeypatch, tb):
    monkeypatch.setattr(pspans, "records", lambda: _store(tb))
    v = _read(TRACED)
    static = 3.0 if tb else 2.0
    assert v["engine_static_gib"] == pytest.approx(static)
    assert v["run_state_gib"] == pytest.approx(12.5)
    assert v["run_held_gib"] == pytest.approx(12.5 + MB / GIB)
    # the peak: engine + held + state, set in the second run
    peak = _store(tb)[-2].mem_peak / GIB
    assert v["engine_static_gib"] + v["run_held_gib"] \
        + v["run_state_gib"] == pytest.approx(peak)
    # the window's runs (3 x 3 ms, 3 x 5 ms), not the warm-up's
    assert v["run_host_ms"] == pytest.approx(12.0)
    assert v["scene_box_s"] == pytest.approx(9.0)
    assert v["scene_rotate_s"] == pytest.approx(2.0)
    assert v["engine_data_s"] == pytest.approx(2.5)
    assert v["engine_upload_s"] == pytest.approx(1.0)


def test_none_where_a_span_is_missing(monkeypatch):
    full = _store()
    for name in ("engine.upload", "run.state", "scene.box", "scene.rotate",
                 "engine.data"):
        monkeypatch.setattr(pspans, "records",
                            lambda: [r for r in full if r.name != name])
        v = _read(TRACED)
        missing = {"engine.upload": ["engine_static_gib", "run_held_gib",
                                     "engine_upload_s"],
                   "run.state": ["run_state_gib", "run_held_gib",
                                 "run_host_ms"],
                   "scene.box": ["scene_box_s"],
                   "scene.rotate": ["scene_rotate_s"],
                   "engine.data": ["engine_data_s"]}[name]
        assert {k for k, x in v.items() if x is None} == set(missing), name
    monkeypatch.setattr(pspans, "records", lambda: [])
    assert set(_read(TRACED).values()) == {None}


def test_memory_metrics_none_off_the_card(monkeypatch):
    monkeypatch.setattr(pspans, "records", lambda: _store(mem=False))
    v = _read(TRACED)
    assert {k for k, x in v.items() if x is None} == {
        "engine_static_gib", "run_state_gib", "run_held_gib"}


def test_nothing_read_without_a_trace_or_without_spans(monkeypatch):
    monkeypatch.setattr(pspans, "records", lambda: _store())
    assert set(_read({"trace": None, "spans": {}}).values()) == {None}
    # a program with no span module (the commit before it had one)
    monkeypatch.delattr(pffdtd_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "pffdtd_tpu_torch.spans", None)
    assert set(_read(TRACED).values()) == {None}


def test_a_small_room_on_the_cpu(tiny):
    """The program's own spans of a small cell's set-up and runs: the
    scene's top-level spans lie within the scene's time, the engine's
    within its constructor's, and no memory is read off the card."""
    cell = tiny("fcc_lossy_box.step")
    cfg, traffic = cell["config"], cell["traffic"]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        pspans.reset()
        src, rx = program.request(cfg, traffic, 2**33 + 5)
        t0 = time.perf_counter_ns()
        sim = program.scene(cfg, traffic, src, rx)
        t1 = time.perf_counter_ns()
        eng = program.engine(cfg, traffic, sim, "cpu")
        t2 = time.perf_counter_ns()
        for nt in (2, 2, None, None):
            eng.run(nt=nt, verbose=False)
    finally:
        torch.set_num_threads(n)
    recs = pspans.records()
    scene = [r for r in recs if r.parent is None and t0 <= r.t0_ns < t1]
    assert [r.name for r in scene] == ["scene.box"] + ["comms.prepare"] * 3 \
        + ["comms.diff_source"] * traffic["diff_source"] \
        + ["scene.rotate", "scene.fold", "scene.sort"]
    assert sum(r.t1_ns - r.t0_ns for r in scene) <= t1 - t0
    v = _read(TRACED)
    assert v["engine_data_s"] + v["engine_upload_s"] <= (t2 - t1) / S
    assert v["run_host_ms"] > 0 and v["scene_box_s"] > 0
    assert v["engine_static_gib"] is v["run_state_gib"] is None
    assert sorted({r.run for r in recs} - {None}) == [1, 2, 3, 4]
    pspans.reset()
