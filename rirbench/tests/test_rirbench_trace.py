"""The trace's reduction on a made-up Chrome trace, and the readers that
take it."""

import pytest

from rirbench import spec
from rirbench.trace import WINDOW, Trace, short


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


K1 = "void (anonymous namespace)::stencil_step_kernel<float, unsigned " \
     "short, 12>(float const*, float const*, unsigned short const*, float*)"
K2 = "void (anonymous namespace)::boundary_update_kernel<float, false>(" \
     "float*)"


@pytest.fixture
def trace():
    t = Trace(cuda=True)
    t.events = [
        ev("user_annotation", WINDOW, 1000.0, 100.0),
        ev("cpu_op", "aten::zeros", 1000.0, 10.0),
        ev("kernel", K1, 1010.0, 40.0),
        ev("kernel", K2, 1050.0, 10.0),
        ev("cpu_op", "aten::to", 1060.0, 20.0),
        ev("kernel", K1, 1080.0, 15.0),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1097.0, 10.0),
        ev("kernel", K1, 900.0, 50.0),     # before the window
        ev("gpu_user_annotation", WINDOW, 1000.0, 100.0)]
    return t


def test_short_names():
    assert short(K1) == "stencil_step_kernel"
    assert short(K2) == "boundary_update_kernel"
    assert short("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_summary(trace):
    s = trace.summary()
    assert s["window_s"] == pytest.approx(100e-6)
    # busy: 1010-1060, 1080-1095, 1097-1100 (the copy clipped)
    assert s["busy_s"] == pytest.approx(68e-6)
    assert len(s["ops"]) == 4
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::to", pytest.approx(20e-6)]
    assert gaps[1] == ["aten::zeros", pytest.approx(10e-6)]
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["stencil_step_kernel"] == pytest.approx(55e-6)


def test_readers(trace):
    run = {"trace": trace.summary(), "grid": (10, 10, 10), "fcc": True,
           "itemsize": 4, "Nbl": 100, "branches": 11, "TB": 3, "Nt": 2,
           "route": "step", "spans": {}}
    idle = spec.reader("device_idle_pct")(run)
    assert idle == pytest.approx(32.0)
    assert spec.reader("kernels_per_step")(run) == 2.0
    k1 = spec.reader("k1_roofline")(run)
    # 512 interior points x 14 B over 3.35 TB/s, over the mean 27.5 us
    assert k1 == pytest.approx(100 * 512 * 14 / 3.35e12 / 27.5e-6)
    assert spec.reader("k3_roofline")(run) is None
    assert 0 < spec.reader("step_roofline")(run) < 100


def test_no_device_work_reads_nothing():
    t = Trace(cuda=False)
    t.events = [ev("user_annotation", WINDOW, 0.0, 10.0),
                ev("cpu_op", "aten::add", 1.0, 2.0)]
    assert t.summary() is None
