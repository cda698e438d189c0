"""The port's NumPy oracle vs the JAX package's, and the port against it.

- `NumpyEngine` (port) `u_out`, `H_tot`, `E_lost` and `E_in` array-equal
  to the JAX package's `NumpyEngine` (the same numpy code: no tolerance)
  on the four scenes of tests/test_torch_energy.py, each set up by the
  port's own `sim_setup_from_room` (held equal to JAX's setup in
  tests/test_torch_setup.py);
- `TorchEngine(device="cpu", dtype=float64)` with energy on against the
  port's oracle, <= 1e-12 of each series' largest magnitude, on the same
  scenes;
- `cli sim --engine numpy` writes a `sim_outs.h5` equal to the JAX CLI's
  `sim --engine numpy` on the same folder, reading the folder from disk.
"""

import h5py
import numpy as np
import pytest
import torch

from pffdtd_tpu.cli import main as jax_cli
from pffdtd_tpu.engine.numpy_ref import NumpyEngine as JaxNumpyEngine
from pffdtd_tpu.engine.numpy_ref import abc_q_grid as jax_abc_q_grid

from pffdtd_tpu_torch.cli import main as port_cli
from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine, abc_q_grid
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.scene import (fold_fcc_sim, make_shoebox_room,
                                    mats_from_DEF_list)
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room

torch.set_num_threads(2)

DEF3 = np.array([[2.0, 5.0, 30.0], [1.0, 10.0, 300.0], [0.5, 8.0, 3000.0]])


def _shoebox(fcc=False, lossy=True, h=0.25, **kw):
    rg = make_shoebox_room(mats=["w"] * 6 if lossy else None)
    md = mats_from_DEF_list([DEF3] if lossy else [])
    return sim_setup_from_room(rg, md, duration=0.02, insig_type="hann10",
                               h=h, fcc_flag=fcc, vox_backend="numpy",
                               block_size=16, **kw)


SCENES = {  # the scenes of tests/test_torch_energy.py
    "rigid-cart": lambda: _shoebox(lossy=False),
    "lossy-cart": lambda: _shoebox(),
    "lossy-fcc": lambda: _shoebox(fcc=True, h=0.2),
    "lossy-fcc-folded": lambda: fold_fcc_sim(_shoebox(fcc=True, h=0.2)),
}
SERIES = ("u_out", "H_tot", "E_lost", "E_in")


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


@pytest.mark.parametrize("name", list(SCENES))
def test_oracle_equals_jax_oracle(name):
    sim = SCENES[name]()
    a = NumpyEngine(**_kw(sim), energy_on=True)
    a.run_all()
    b = JaxNumpyEngine(**_kw(sim), energy_on=True)
    b.run_all()
    assert a.n == b.n == sim.comms.Nt
    for k in SERIES:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    np.testing.assert_array_equal(a.energy_balance(), b.energy_balance())
    assert np.abs(a.u_out).max() > 0
    for folded in (False, True):
        np.testing.assert_array_equal(abc_q_grid(5, 6, 7, folded),
                                      jax_abc_q_grid(5, 6, 7, folded))


@pytest.mark.parametrize("name", list(SCENES))
def test_torch_engine_matches_port_oracle(name):
    sim = SCENES[name]()
    o = NumpyEngine(**_kw(sim), energy_on=True)
    o.run_all()
    t = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu",
                    energy_on=True)
    u = t.run(verbose=False)
    n = o.n
    # the oracle's E rows are pre-step (E[0] = 0), the engine's post-step
    pairs = {"u_out": (u, o.u_out), "H_tot": (t.H_tot, o.H_tot[:n]),
             "E_lost": (t.E_lost, o.E_lost[1:n + 1]),
             "E_in": (t.E_in, o.E_in[1:n + 1])}
    for k, (mine, ref) in pairs.items():
        scale = np.abs(ref).max()
        if k == "E_lost" and name == "rigid-cart":
            assert scale == 0 and not mine.any()
            continue
        assert scale > 0, k
        assert np.abs(mine - ref).max() / scale <= 1e-12, k
    assert np.abs(t.energy_balance()).max() < 1e-10


def _outs(folder):
    with h5py.File(folder / "sim_outs.h5", "r") as f:
        return {k: (f[k].dtype, f[k][()]) for k in f.keys()}


def test_cli_sim_numpy_equals_jax_cli(tmp_path, capsys):
    """A sorted folded FCC folder (so out_reorder is not the identity)."""
    from pffdtd_tpu_torch.prep import fold_fcc_sim_data, sort_sim_data

    for d in ("port", "jax"):
        _shoebox(fcc=True, h=0.2, save_folder=tmp_path / d)
        fold_fcc_sim_data(tmp_path / d)
        sort_sim_data(tmp_path / d)
    port_cli(["sim", "--data_dir", str(tmp_path / "port"), "--engine",
              "numpy", "--energy"])
    out = capsys.readouterr().out
    assert "--ENGINE(numpy): max |energy balance|" in out
    jax_cli(["sim", "--data_dir", str(tmp_path / "jax"), "--engine",
             "numpy", "--energy"])
    a, b = _outs(tmp_path / "port"), _outs(tmp_path / "jax")
    assert a.keys() == b.keys() == {"u_out"}
    assert a["u_out"][0] == b["u_out"][0]
    np.testing.assert_array_equal(a["u_out"][1], b["u_out"][1])
    assert np.abs(a["u_out"][1]).max() > 0
