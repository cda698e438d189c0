"""`pffdtd_tpu_torch.bench`, the port's bench, on the CPU.

- each item's scene is array-equal to the one bench.py builds: bench.py's
  own item functions run with `pffdtd_tpu.demo.synthetic_box_sim` replaced
  by a recorder, which keeps their arguments and stops them, and the scene
  is rebuilt from those arguments at a reduced h (the headline's through
  the BENCH_* size knobs);
- the drift and spectral items at 256 steps on the CPU against bench.py's
  own functions on JAX's CPU: the ratios within 1e-4 relative, the dB
  within 1e-3 dB (measured: the ratios differ by 2.6e-5 and 1.6e-5
  relative, the dB by 6.4e-4, 0.0454 against 0.0448: the two engines'
  fp32 roundings differ, and the spectral measure amplifies them);
- the runner with a stub child: the line is re-printed after each item, a
  hung child is killed and the run goes on, an item over the budget and
  one without an estimate are skipped, a failed headline is replaced by
  its fallback with `headline_note`, the final line has its keys and its
  `device`, and each child's launches are passed on to stderr;
- `counted` sets the launch counts to 0 before each run and records what
  the run launched with its route; the drift items' records;
- `main()` raises without a card before any child starts.
bench.py imports only numpy at its top; it is loaded by path.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pffdtd_tpu import demo, prep

from pffdtd_tpu_torch import bench
from pffdtd_tpu_torch.scene import HEADLINE_RX, headline_rxyz

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load_jax_bench()


class _Stop(Exception):
    pass


def _bench_py_args(monkeypatch, call):
    """The (args, kwargs) with which bench.py's `call` builds its scene."""
    seen = []

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        raise _Stop

    monkeypatch.setattr(demo, "synthetic_box_sim", record)
    with pytest.raises(_Stop):
        call()
    monkeypatch.undo()
    return seen[0]


def _jax_scene(args, kwargs, h, fcc_prep):
    sim = demo.synthetic_box_sim(*args, **dict(kwargs, h=h))
    if fcc_prep:
        sim = prep.sort_sim(prep.fold_fcc_sim(
            prep.rotate_sim(sim, orient="descending")))
    return sim


def _assert_sim_equal(a, b):
    for part in ("consts", "vox", "comms", "mats"):
        pa, pb = getattr(a, part), getattr(b, part)
        for k, vb in vars(pb).items():
            np.testing.assert_array_equal(np.asarray(getattr(pa, k)),
                                          np.asarray(vb),
                                          err_msg=f"{part}.{k}")


SIZE = {"BENCH_H": "0.9", "BENCH_NT": "8"}
# item: (the port's scene at a reduced h, reduced h, FCC prep on bench.py's)
ITEMS = {
    "fcc_lossy": (lambda h: bench.synthetic_scene(
        True, True, 36.0, 28.0, 23.0, h, 8), 0.9, True),
    "fcc_lossy_1e9": (lambda h: bench.synthetic_scene(
        True, True, 108.0, 34.0, 28.0, h, 8), 1.2, True),
    "fcc_rigid": (lambda h: bench.synthetic_scene(
        True, False, 36.0, 28.0, 23.0, h, 8), 0.9, True),
    "cart_rigid": (lambda h: bench.synthetic_scene(
        False, False, 36.0, 28.0, 23.0, h, 8), 0.9, False),
    "cart_lossy": (lambda h: bench.synthetic_scene(
        False, True, 36.0, 28.0, 23.0, h, 8), 0.9, False),
    "cart_rigid_1e9": (lambda h: bench.synthetic_scene(
        False, False, 150.0, 25.0, 28.6, h, 8), 1.5, False),
    "energy_pair": (lambda h: bench.synthetic_scene(
        True, True, 28.0, 22.0, 18.0, h, 512), 0.9, True),
    "sharded_pair": (lambda h: bench.sharded_scene("pair", 64, h), 0.6,
                     False),
    "sharded_pallas": (lambda h: bench.sharded_scene("step", 64, h), 0.35,
                       False),
    "fp32_spectral": (lambda h: bench.spectral_scene(8192, h), 0.12, False),
    "fp32_drift": (lambda h: bench.drift_scene(50000, False, h), 0.15,
                   False),
    "fp32_drift_lossy": (lambda h: bench.drift_scene(50000, True, h), 0.15,
                         False),
}


@pytest.mark.parametrize("item", list(ITEMS))
def test_item_scene_equals_bench_py(item, monkeypatch):
    for k, v in SIZE.items():
        monkeypatch.setenv(k, v)
    fn = {n: f for n, _, f in jbench.build_items()}[item]
    args, kwargs = _bench_py_args(monkeypatch, fn)
    port, h, fcc_prep = ITEMS[item]
    _assert_sim_equal(port(h), _jax_scene(args, kwargs, h, fcc_prep))
    # the port's items name the same items in the same order
    names = [n for n, _, _ in bench.build_items()]
    assert names[:-1] == [n for n, _, _ in jbench.build_items()]
    assert names[-1] == "roof"


def test_headline_receivers_are_the_one_change():
    """The headline's grid and nodes are bench.py's; its receivers sit
    1.6 and 2.1 m from the source."""
    L, h = (36.0, 28.0, 23.0), 0.9
    a = bench.synthetic_scene(True, True, *L, h, 8,
                              rxyz=headline_rxyz(*L))
    b = bench.synthetic_scene(True, True, *L, h, 8)
    for k in ("bn_ixyz", "adj_bn", "mat_bn", "saf_bn"):
        np.testing.assert_array_equal(getattr(a.vox, k), getattr(b.vox, k))
    np.testing.assert_array_equal(a.comms.in_ixyz, b.comms.in_ixyz)
    d = np.linalg.norm(HEADLINE_RX, axis=1)
    np.testing.assert_allclose(d, [1.64, 2.11], atol=0.005)


@pytest.mark.parametrize("lossy", [False, True])
def test_fp32_drift_matches_bench_py(lossy):
    bench.LAUNCHES.clear()
    port = bench.fp32_energy_drift(nsteps=256, lossy=lossy, device="cpu")
    ref = jbench.fp32_energy_drift(nsteps=256, lossy=lossy)
    assert np.isfinite(port) and abs(port - ref) <= 1e-4 * abs(ref)
    # one counted run on the step route; on the CPU no kernel launches, and
    # the open-top box's lossy nodes reach the top ABC layer
    [r] = bench.LAUNCHES
    assert r["tag"] == "fp32_drift" + "_lossy" * lossy
    assert (r["route"], r["TB"], r["x_slabs"], r["nt"]) == ("step", None,
                                                           0, 256)
    assert r["lossy"] == lossy and (r["abc_nodes"] > 0) == lossy
    assert r["launches"] == {}


class _FakeEngine:
    """An engine whose run 'launches' K1 and K2 once a step."""
    backend, TB, D, mvps = "step", None, 0, 1.0

    def __init__(self):
        self.data = type("D", (), {"Nbl": 3, "abcq_bnl": None})()
        self.u_out = np.ones((1, 4))

    def run(self, nt, verbose):
        for k in ("K1", "K2"):
            bench.WRAPPERS[k].launches += nt
        return self.u_out


def test_timed_counts_each_run_from_zero():
    bench.LAUNCHES.clear()
    bench.WRAPPERS["K3"].launches = 99     # left from an earlier run
    bench.timed(_FakeEngine(), 8, "t")
    assert len(bench.LAUNCHES) == 4
    assert all(r == {"tag": "t", "route": "step", "TB": None, "x_slabs": 0,
                     "nt": 8, "lossy": True, "abc_nodes": 0,
                     "launches": {"K1": 8, "K2": 8}} for r in bench.LAUNCHES)
    bench._reset_counts()


def test_fp32_spectral_matches_bench_py():
    port = bench.fp32_vs_fp64_rir_db(nsteps=256, device="cpu")
    ref = jbench.fp32_vs_fp64_rir_db(nsteps=256)
    assert abs(port - ref) <= 1e-3


STUB = r"""
import json, os, sys, time
name = os.environ["BENCH_CHILD"]
res = {"head": {"__headline__": 1000.0, "head_tb": 900.0},
       "half": {"__headline__": 400.0},
       "a": {"a_mvps": 12.5, "a_err": 7.7e-6},
       "b": {"b_mvps": 3.0}}
if name == "hang":
    time.sleep(120)
if name == "head" and os.environ.get("STUB_FAIL_HEAD"):
    sys.exit(1)
print("engine chatter")
if name in res:
    print("BENCH_LAUNCHES " + json.dumps([{"tag": name, "launches": {"K1": 2}}]))
    print("BENCH_RESULT " + json.dumps(res[name]))
"""
DEVICE = {"name": "stub card", "power_limit_w": 700.0, "count": 1}


def _stub_run(tmp_path, capsys, budget, fail_head=False, monkeypatch=None):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    if fail_head:
        monkeypatch.setenv("STUB_FAIL_HEAD", "1")
    items = [("head", 1, None), ("half", 0, None), ("a", 1, None),
             ("hang", 1, None), ("b", 1, None), ("absent", 0, None),
             ("huge", 10**6, None)]
    line = bench.run(items, DEVICE, budget=budget,
                     cmd=[sys.executable, str(stub)])
    cap = capsys.readouterr()
    lines = [json.loads(s) for s in cap.out.splitlines() if s.strip()]
    return line, lines, cap.err


def test_runner_reemits_kills_skips_and_ends_with_the_line(tmp_path, capsys):
    # budget: the hung child's limit is remaining - 30, a few seconds
    line, lines, err = _stub_run(tmp_path, capsys, budget=36.0)
    assert line["metric"] == bench.METRIC and line["value"] == 1000.0
    assert line["vs_baseline"] == round(1000.0 / bench.BASELINE_MVPS, 4)
    assert line["device"] == DEVICE and "headline_note" not in line
    assert line["secondary"] == {"head_tb": 900.0, "a_mvps": 12.5,
                                 "a_err": 7.7e-6, "b_mvps": 3.0}
    # the headline, then after each item run (a, hang, b), then the end
    assert len(lines) == 5
    assert lines[1]["secondary"]["a_mvps"] == 12.5
    assert "b_mvps" not in lines[2]["secondary"]
    assert lines[-1] == dict(line, elapsed_s=lines[-1]["elapsed_s"])
    assert "hang TIMED OUT" in err and "SKIP huge" in err
    assert "SKIP absent" in err and "engine chatter" in err
    got = [ln.split(" ", 2) for ln in err.splitlines()
           if ln.startswith("BENCH_LAUNCHES ")]
    assert [(i, json.loads(p)) for _, i, p in got] == [
        (i, [{"tag": i, "launches": {"K1": 2}}]) for i in ("head", "a", "b")]


def test_runner_falls_back_to_half_size(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_SKIP", "hang")
    line, _, err = _stub_run(tmp_path, capsys, budget=600.0, fail_head=True,
                             monkeypatch=monkeypatch)
    assert line["value"] == 400.0
    assert line["headline_note"] == "half_scale_fallback_grid"
    assert "head produced no result" in err
    assert set(line["secondary"]) == {"a_mvps", "a_err", "b_mvps"}


def test_main_raises_without_a_card_before_any_child(monkeypatch):
    started = []
    monkeypatch.setattr(bench._Run, "run_child",
                        lambda *a: started.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main()
    assert started == []
