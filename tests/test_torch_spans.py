"""The port's spans (`pffdtd_tpu_torch.spans`) on the CPU: the records of
nested spans, the profiler's ranges, the spans of the set-up stages and of
`TorchEngine.run` (once a call, none a step), results unchanged under a
profiler, the bounded store, the kernel library's span, and the stage
table that `examples.setup_1e9` and chip_smoke.py print."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pffdtd_tpu_torch import spans
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples.setup_1e9 import STAGES, stage_seconds
from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.scene import (fold_fcc_sim, make_sloped_room,
                                    mats_from_DEF_list, rotate_sim, sort_sim,
                                    synthetic_box_sim)
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room

RUN_SPANS = ["run.signals", "run.state", "run.receivers"]


@pytest.fixture(autouse=True)
def _store():
    spans.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    spans.reset()


def _busy(ns):
    t = time.perf_counter_ns()
    while time.perf_counter_ns() - t < ns:
        pass


def _by_name():
    return {r.name: r for r in spans.records()}


def test_nested_spans_record_parents_runs_and_self_time():
    @spans.numbered_run
    def a_run():
        with spans.span("run.inner"):
            pass
        return spans.records()[-1].run

    with spans.span("outer"):
        _busy(200_000)
        with spans.span("mid"):
            _busy(200_000)
            with spans.span("leaf"):
                _busy(200_000)
        with spans.span("side"):
            _busy(100_000)
    assert [r.name for r in spans.records()] == ["leaf", "mid", "side",
                                                 "outer"]
    r = _by_name()
    assert [r[k].parent for k in ("leaf", "mid", "side", "outer")] == \
        ["mid", "outer", "outer", None]
    assert all(x.run is None for x in r.values())
    assert r["outer"].child_ns == r["mid"].t1_ns - r["mid"].t0_ns \
        + r["side"].t1_ns - r["side"].t0_ns
    assert r["mid"].self_seconds == pytest.approx(
        r["mid"].seconds - r["leaf"].seconds, abs=1e-12)
    assert r["leaf"].self_seconds == r["leaf"].seconds >= 2e-4
    assert r["outer"].self_seconds >= 2e-4
    assert r["outer"].t0_ns <= r["mid"].t0_ns < r["leaf"].t0_ns \
        < r["leaf"].t1_ns <= r["mid"].t1_ns < r["side"].t0_ns \
        < r["side"].t1_ns <= r["outer"].t1_ns
    assert [a_run(), a_run()] == [1, 2]
    with spans.span("after"):
        pass
    assert spans.records()[-1].run is None
    since = spans.records()[-1].t0_ns
    assert [x.name for x in spans.records(since)] == ["after"]


def test_decorated_function_is_a_span_and_keeps_its_signature():
    @spans.span("f")
    def f(x, *, y=2):
        """doc"""
        return x + y

    assert f(1) == 3 and f.__doc__ == "doc" and f.__name__ == "f"
    assert [r.name for r in spans.records()] == ["f"]


def test_profiler_ranges_only_while_it_profiles(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("stage"):
            torch.ones(8).add_(1)
    names = [e.name for e in prof.events()]
    assert "pffdtd.stage" in names
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    with spans.span("quiet"):
        torch.ones(8).add_(1)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("loud"):
            pass
    assert opened == ["pffdtd.loud"]


def test_store_is_bounded():
    for i in range(spans.MAX_RECORDS + 10):
        with spans.span(f"s{i}"):
            pass
    recs = spans.records()
    assert len(recs) == spans.MAX_RECORDS
    assert recs[0].name == "s10"
    assert recs[-1].name == f"s{spans.MAX_RECORDS + 9}"


def test_memory_fields_are_none_on_the_cpu():
    for mem in (None, "cpu", torch.device("cpu")):
        with spans.span("m", mem=mem):
            torch.zeros(100)
    assert all(r.mem_in is r.mem_out is r.mem_peak is None
               for r in spans.records())


def _box():
    return sort_sim(fold_fcc_sim(rotate_sim(synthetic_box_sim(
        2.2, 1.8, 1.5, h=0.12, Nt=40, fcc=True, lossy=True,
        insig_type="hann10", diff_source=False))))


def _engine(sim, route):
    kw = {"backend": "tb", "tb": 3} if route == "tb" else {}
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=np.float64, device="cpu", **kw)


def test_scene_stages_are_spans():
    _box()
    recs = spans.records()
    names = [r.name for r in recs]
    assert names == ["comms.prepare"] * 3 + ["scene.box", "scene.rotate",
                                             "scene.fold", "scene.sort"]
    assert {r.parent for r in recs[:3]} == {"scene.box"}
    assert all(r.parent is None and r.run is None for r in recs[3:])
    box = recs[3]
    assert box.child_ns == sum(r.t1_ns - r.t0_ns for r in recs[:3])


@pytest.mark.parametrize("route", ["step", "tb"])
def test_run_spans_once_a_call_whatever_its_steps(route):
    eng = _engine(_box(), route)
    setup = [r.name for r in spans.records()]
    want = ["engine.data", "engine.upload"] + (
        ["engine.tb_scene"] if route == "tb" else [])
    assert setup[-len(want):] == want
    spans.reset()
    eng.run(nt=4, verbose=False)
    eng.run(nt=40, verbose=False)
    recs = spans.records()
    assert [(r.name, r.run, r.parent) for r in recs] == \
        [(n, k, None) for k in (1, 2) for n in RUN_SPANS]
    loop = [b.t0_ns - a.t1_ns for a, b in zip(recs[1::3], recs[2::3])]
    assert loop[1] > loop[0] > 0


def test_results_bitwise_with_and_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    sim = _box()
    for route in ("step", "tb"):
        a = _engine(sim, route)
        u = a.run(verbose=False)
        b = _engine(sim, route)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ub = b.run(verbose=False)
        assert "pffdtd.run.state" in {e.name for e in prof.events()}
        assert np.array_equal(u, ub)
        assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))


def test_checkpoint_save_is_a_span(tmp_path):
    eng = _engine(_box(), "step")
    spans.reset()
    eng.run(nt=12, verbose=False, chunk=4, checkpoint_every=1,
            checkpoint_path=tmp_path / "s.npz")
    ck = [r for r in spans.records() if r.name == "run.checkpoint"]
    assert len(ck) == 3 and {(r.run, r.parent) for r in ck} == {(1, None)}


def test_kernel_library_span_covers_the_build_or_load_only(monkeypatch):
    got = object()
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD", _FoundBuild())
    monkeypatch.setattr(_build, "KernelLibrary", lambda *a: got)
    assert _build.library() is got and _build.library() is got
    assert [(r.name, r.parent) for r in spans.records()] == \
        [("kernels.library", None)]


class _FoundBuild:
    """A build directory in which every library is already built."""

    def __truediv__(self, name):
        return SimpleNamespace(exists=lambda: True)


def test_setup_stage_table_from_spans():
    """`stage_seconds` on `sim_setup_from_room` (numpy voxelizer): the
    labels setup_1e9 and chip_smoke.py print, in their order, from the
    program's spans."""
    since = time.perf_counter_ns()
    t0 = time.perf_counter()
    sim_setup_from_room(make_sloped_room(), mats_from_DEF_list(
        [np.array([[2.0, 5.0, 30.0]])] * 2), duration=0.005,
        insig_type="impulse", h=0.2, fcc_flag=False, diff_source=True,
        vox_backend="numpy", check_adj=True)
    st = stage_seconds(since, time.perf_counter() - t0)
    assert list(st) == [*STAGES, "rest", "total"]
    assert list(STAGES) == [
        "voxelize", "of which native", "of which symmetrize",
        "of which materials + SAF", "check_adj_full", "comms",
        "of which diff_source", "clash check"]
    assert st["of which native"] == 0.0
    assert all(st[k] > 0 for k in STAGES if k != "of which native")
    assert st["of which symmetrize"] + st["of which materials + SAF"] \
        <= st["voxelize"]
    assert 0 <= st["rest"] < st["total"]
    top = sum(st[k] for k in ("voxelize", "check_adj_full", "comms",
                              "clash check"))
    assert st["rest"] == pytest.approx(st["total"] - top, abs=1e-9)
