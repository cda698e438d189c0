"""The port's `prep` folder stages vs the JAX package's, dataset by dataset.

Two copies of one sim folder (written by the port's setup, held equal to
the JAX package's in tests/test_torch_setup.py) go through the port's
`cli prep` and the JAX CLI's `prep` with the same flags, and must hold the
same files, datasets, dtypes and values.  Both CLIs' `--rotate` rotate by
"auto", each by its own rule (the JAX package's scores TPU tilings, the
port's its step route on the H100), so on the JAX side the rotation is
`prep.rotate_sim(tr=<the port's choice>)` stored with the JAX package's
own `_store`, and the rest of the flags run through its CLI.
"""

import numpy as np
import pytest

from pffdtd_tpu import prep as jprep
from pffdtd_tpu.cli import main as jax_cli

from pffdtd_tpu_torch import prep
from pffdtd_tpu_torch.cli import main as port_cli
from pffdtd_tpu_torch.io.simdata import read_sim_folder
from pffdtd_tpu_torch.scene import (make_sloped_room, mats_from_DEF_list,
                                    rotation_of)
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room

from test_torch_setup import assert_folders_equal

DEF3 = np.array([[2.0, 5.0, 30.0], [1.0, 10.0, 300.0], [0.5, 8.0, 3000.0]])


def _folder(path, fcc):
    """The sloped room (2 x 3 m, ceiling 1.6 to 2.5 m): Ny is the longest
    dim, so a rotation, "auto" or "descending", permutes the grid."""
    sim_setup_from_room(make_sloped_room(),
                        mats_from_DEF_list([DEF3, 2.0 * DEF3]),
                        duration=0.005, insig_type="hann10", h=0.12,
                        fcc_flag=fcc, vox_backend="numpy", block_size=16,
                        save_folder=path)
    return path


@pytest.mark.parametrize("flags", [["--fold"], ["--sort"],
                                   ["--fold", "--sort"], ["--rotate"],
                                   ["--rotate", "--sort"],
                                   ["--rotate", "--fold", "--sort"]])
def test_prep_folders_equal(tmp_path, flags):
    fcc = "--fold" in flags or flags == ["--rotate"]
    a, b = _folder(tmp_path / "port", fcc), _folder(tmp_path / "jax", fcc)
    before = read_sim_folder(a)
    tr = rotation_of(before)
    port_cli(["prep", "--data_dir", str(a), *flags])
    rest = [f for f in flags if f != "--rotate"]
    if "--rotate" in flags:
        jprep._store(b, jprep.rotate_sim(jprep._load(b), tr=tr))
    if rest:
        jax_cli(["prep", "--data_dir", str(b), *rest])
    assert_folders_equal(a, b)
    sim = read_sim_folder(a)
    if "--rotate" in flags:
        N = (before.vox.Nx, before.vox.Ny, before.vox.Nz)
        assert tr != (0, 1, 2)
        assert (sim.vox.Nx, sim.vox.Nz) == (N[tr[0]], N[tr[2]])
    if "--sort" in flags:
        assert np.all(np.diff(sim.vox.bn_ixyz) > 0)
        assert not np.array_equal(sim.comms.out_reorder,
                                  np.arange(sim.comms.Nr))
    assert sim.consts.fcc_flag == (2 if "--fold" in flags else int(fcc))


def test_copy_and_explicit_rotation(tmp_path):
    """copy_sim_data copies every .h5; rotate_sim_data(tr=...) equals the
    JAX package's rotation with the same permutation."""
    a = _folder(tmp_path / "a", False)
    prep.copy_sim_data(a, tmp_path / "port")
    jprep.copy_sim_data(a, tmp_path / "jax")
    assert_folders_equal(tmp_path / "port", a)
    prep.rotate_sim_data(tmp_path / "port", tr=(2, 0, 1))
    jprep.rotate_sim_data(tmp_path / "jax", tr=(2, 0, 1))
    assert_folders_equal(tmp_path / "port", tmp_path / "jax")
