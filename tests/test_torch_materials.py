"""The port's material tools vs the JAX package's, array for array.

The converters, `to_DEF`/`from_DEF`, `compute_Rf_from_DEF`, the material
file writers, `fit_to_Sabs_oct_11` (the same numpy code and the same
Nelder-Mead: exact equality), and the `.h5` that `cli fit-material`
writes against the JAX CLI's for the same `--sabs`.
"""

import h5py
import numpy as np
import pytest

from pffdtd_tpu import materials as jmat
from pffdtd_tpu.cli import main as jax_cli

from pffdtd_tpu_torch import materials as mat
from pffdtd_tpu_torch.cli import main as port_cli
from pffdtd_tpu_torch.io.h5 import read_mat_file

RNG = np.random.default_rng(5)
DEF = np.abs(RNG.standard_normal((4, 3))) + 0.1
JW = 1j * 2 * np.pi * np.geomspace(10.0, 2e4, 50)
CASES = {
    "convert_nabs_to_R": (0.37,),
    "convert_Yn_to_R": (RNG.uniform(0.01, 2.0, 9),),
    "convert_R_to_Yn": (RNG.uniform(-0.9, 0.99, 9),),
    "convert_R_to_Zn": (RNG.uniform(-0.9, 0.99, 9),),
    "convert_Sabs_to_Yn": (0.42,),
    "compute_Rf_from_DEF": (JW, *DEF.T),
    "to_DEF": tuple(RNG.uniform(0.1, 3.0, (3, 6))),
    "from_DEF": tuple(DEF.T),
}


@pytest.mark.parametrize("fn", list(CASES))
def test_converters_equal(fn):
    a = getattr(mat, fn)(*CASES[fn])
    b = getattr(jmat, fn)(*CASES[fn])
    for x, y in zip(np.atleast_1d(a) if not isinstance(a, tuple) else a,
                    np.atleast_1d(b) if not isinstance(b, tuple) else b):
        np.testing.assert_array_equal(x, y)
    assert mat.convert_Sabs_to_Yn(0.99) == jmat.convert_Sabs_to_Yn(0.99)
    assert mat.convert_Sabs_to_Yn(0.0) == jmat.convert_Sabs_to_Yn(0.0) == 0


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k][()]) for k in f.keys()}


def _assert_files_equal(a, b):
    fa, fb = _h5(a), _h5(b)
    assert fa.keys() == fb.keys() == {"DEF"}
    assert fa["DEF"][0] == fb["DEF"][0]
    np.testing.assert_array_equal(fa["DEF"][1], fb["DEF"][1])


def test_fit_and_writers_equal(tmp_path):
    sabs = np.linspace(0.05, 0.30, 11)
    a = mat.fit_to_Sabs_oct_11(sabs, filename=tmp_path / "port.h5")
    b = jmat.fit_to_Sabs_oct_11(sabs, filename=tmp_path / "jax.h5")
    assert a.shape == (11, 3) and np.all(a > 0)
    np.testing.assert_array_equal(a, b)
    _assert_files_equal(tmp_path / "port.h5", tmp_path / "jax.h5")
    np.testing.assert_array_equal(read_mat_file(tmp_path / "port.h5"), a)
    for fn, arg in (("write_freq_ind_mat_from_Zn", 3.5),
                    ("write_freq_ind_mat_from_Yn", 0.2),
                    ("write_freq_dep_mat", DEF)):
        getattr(mat, fn)(arg, tmp_path / f"{fn}.port.h5")
        getattr(jmat, fn)(arg, tmp_path / f"{fn}.jax.h5")
        _assert_files_equal(tmp_path / f"{fn}.port.h5",
                            tmp_path / f"{fn}.jax.h5")


def test_cli_fit_material_equals_jax_cli(tmp_path, capsys):
    sabs = ",".join(f"{x:.3f}" for x in np.linspace(0.02, 0.10, 11))
    port_cli(["fit-material", "--out", str(tmp_path / "port.h5"), "--sabs",
              sabs])
    assert "DEF=" in capsys.readouterr().out
    jax_cli(["fit-material", "--out", str(tmp_path / "jax.h5"), "--sabs",
             sabs])
    _assert_files_equal(tmp_path / "port.h5", tmp_path / "jax.h5")
