"""Chunked runs, checkpoint/resume and the per-chunk hook of TorchEngine (CPU,
the plain versions), after tests/test_cli_checkpoint.py:

- a chunked run bitwise equal to the single run on the step, tb (TB = 3,
  chunk 13, rounded up to 15) and pair routes;
- a checkpoint at n = 24, resumed in a fresh engine, bitwise equal to the
  uninterrupted run; a checkpoint at a step that is no multiple of TB
  (n = 23), resumed, bitwise equal too; energy + checkpoint, bitwise;
- a resume against another scene, dtype, route or energy setting refuses;
- the port resumed from a JAX XLA-route run stopped at n = 24 (its carry
  through convert.checkpoint_from_jax) equals JAX's uninterrupted run to
  1e-12 (fp64);
- on_chunk sees the chunk ends, on a TB route too;
- render_animation and LiveSliceView write PNGs.
"""

import numpy as np
import pytest
import torch

from pffdtd_tpu.demo import synthetic_box_sim as jax_box_sim
from pffdtd_tpu.engine.jax_engine import JaxEngine

from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.scene import fold_fcc_sim, synthetic_box_sim

torch.set_num_threads(2)

ROUTES = {"step": {"backend": "step"}, "tb3": {"backend": "tb", "tb": 3},
          "pair": {"backend": "pair"}}


def _sim(fcc=False):
    sim = synthetic_box_sim(2.2, 1.8, 1.5, h=0.12, Nt=48, lossy=True,
                            fcc=fcc, insig_type="hann10", diff_source=False)
    return fold_fcc_sim(sim) if fcc else sim


def _engine(sim, **kw):
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=np.float64, device="cpu", **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunked_run_matches_single(route):
    sim = _sim(fcc=route == "tb3")
    a, b = _engine(sim, **ROUTES[route]), _engine(sim, **ROUTES[route])
    assert np.array_equal(b.run(verbose=False, chunk=13),
                          a.run(verbose=False))
    assert np.array_equal(b.state[1].numpy(), a.state[1].numpy())


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("stop", [24, 23])
def test_checkpoint_resume(route, stop, tmp_path):
    """stop 23: the run to 23 in chunks of 5 (rounded up to whole sweeps)
    checkpoints at its last chunk, n = 23 on the TB routes (no multiple of
    TB), n = 20 on the step route."""
    sim = _sim()
    ck = tmp_path / "state.npz"
    a = _engine(sim, **ROUTES[route])
    a.run(verbose=False)
    b = _engine(sim, **ROUTES[route])
    if stop == 24:
        b.run(nt=24, verbose=False, chunk=12, checkpoint_every=2,
              checkpoint_path=ck)
    else:
        b.run(nt=23, verbose=False, chunk=5, checkpoint_every=2,
              checkpoint_path=ck)
    with np.load(ck) as z:
        n = int(z["n"])
    assert n == (20 if (stop, route) == (23, "step") else stop)
    c = _engine(sim, **ROUTES[route])
    u = c.run(verbose=False, chunk=12, checkpoint_path=ck, resume=True)
    assert np.array_equal(u, a.u_out)
    assert np.array_equal(c.state[1].numpy(), a.state[1].numpy())


def test_resume_without_a_checkpoint_starts_from_zero(tmp_path):
    sim = _sim()
    a = _engine(sim).run(verbose=False)
    b = _engine(sim).run(verbose=False, checkpoint_path=tmp_path / "no.npz",
                         resume=True)
    assert np.array_equal(a, b)


def test_energy_checkpoint_resume(tmp_path):
    sim = _sim(fcc=True)
    ck = tmp_path / "state.npz"
    a = _engine(sim, energy_on=True)
    a.run(verbose=False)
    b = _engine(sim, energy_on=True)
    b.run(verbose=False, chunk=7)
    c = _engine(sim, energy_on=True)
    c.run(nt=24, verbose=False, chunk=6, checkpoint_every=2,
          checkpoint_path=ck)
    d = _engine(sim, energy_on=True)
    d.run(verbose=False, chunk=12, checkpoint_path=ck, resume=True)
    for e in (b, d):
        for k in ("u_out", "H_tot", "E_lost", "E_in"):
            assert np.array_equal(getattr(e, k), getattr(a, k)), k
    assert np.abs(d.energy_balance()).max() < 1e-10


@pytest.mark.parametrize("other", ["scene", "dtype", "route", "energy"])
def test_resume_refuses_a_mismatch(other, tmp_path):
    sim = _sim()
    ck = tmp_path / "state.npz"
    _engine(sim).run(nt=12, verbose=False, checkpoint_every=1,
                     checkpoint_path=ck)
    if other == "scene":
        e = _engine(synthetic_box_sim(2.0, 1.8, 1.5, h=0.12, Nt=48,
                                      lossy=True, insig_type="hann10"))
    elif other == "dtype":
        e = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                        mats=sim.mats, dtype=np.float32, device="cpu")
    elif other == "route":
        e = _engine(sim, backend="pair")
    else:
        e = _engine(sim, energy_on=True)
    with pytest.raises(ValueError, match="refusing to resume"):
        e.run(verbose=False, checkpoint_path=ck, resume=True)


def test_resume_from_a_jax_run(tmp_path):
    sim = jax_box_sim(2.2, 1.8, 1.5, h=0.12, Nt=48, lossy=True,
                      insig_type="hann10", diff_source=False)
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
              mats=sim.mats, dtype=np.float64)
    a = JaxEngine(**kw)
    a.run(verbose=False)
    jck, ck = tmp_path / "jax.npz", tmp_path / "torch.npz"
    b = JaxEngine(**kw)
    b.run(nt=24, verbose=False, chunk=24, checkpoint_every=1,
          checkpoint_path=jck)
    t = TorchEngine(**kw, device="cpu")
    convert.checkpoint_from_jax(jck, b.data, t, ck)
    u = t.run(verbose=False, checkpoint_path=ck, resume=True)
    scale = np.abs(a.u_out).max()
    assert scale > 0
    assert np.abs(u - a.u_out).max() / scale < 1e-12


@pytest.mark.parametrize("route", ["step", "tb3"])
def test_on_chunk_sees_the_chunk_ends(route):
    sim = _sim()
    seen = []

    def record(n, state):   # a non-plotting hook: the step and max |u^n|
        seen.append((n, float(state[1].abs().max())))

    eng = _engine(sim, **ROUTES[route])
    u = eng.run(verbose=False, chunk=10,
                on_chunk=record)
    c = 10 if route == "step" else 12      # rounded up to whole sweeps
    assert [n for n, _ in seen] == list(range(c, eng.Nt, c)) + [eng.Nt]
    assert seen[-1][1] == float(eng.state[1].abs().max()) > 0
    assert np.isfinite(u).all()


def test_render_animation_and_live_view(tmp_path):
    pytest.importorskip("matplotlib")
    from pffdtd_tpu_torch.viz import LiveSliceView, render_animation

    sim = _sim(fcc=True)
    eng = _engine(sim)
    files = render_animation(eng, frames=4, steps_per_frame=eng.Nt // 4 + 1,
                             out_dir=tmp_path / "frames", fcc=True)
    assert [f.name for f in files] == [f"frame_{k:04d}.png"
                                       for k in range(4)]
    assert all(f.stat().st_size > 1000 for f in files)
    view = LiveSliceView(eng, show=False, out_dir=tmp_path / "live")
    eng.run(verbose=False, chunk=eng.Nt // 3 + 1, on_chunk=view)
    live = sorted((tmp_path / "live").glob("live_*.png"))
    assert len(live) == 3 and all(f.stat().st_size > 1000 for f in live)
