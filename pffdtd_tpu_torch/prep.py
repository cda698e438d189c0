"""Sim-folder preparation stages: rotate, FCC-fold, sort, copy.

Copy of the folder stages of pffdtd_tpu/prep.py (`copy_sim_data`,
`_store`, `rotate_sim_data`, `fold_fcc_sim_data`, `sort_sim_data`) over the
port's folder reader `io.simdata.read_sim_folder` (JAX's `_load`) and its
in-memory transforms in `scene.py` (`rotate_sim`, `fold_fcc_sim`,
`sort_sim`), re-exported here.  They rewrite a sim folder's HDF5 files in
place (cart_grid.h5 is never touched: it keeps the original orientation);
h5py is imported when they run.  `rotate_sim_data` permutes the grid's
dims by "auto", the JAX package's default, or applies an explicit `tr`;
"auto" scores each axis on z with the port's own cost model of its step
route on the H100 (`orientation_scores`, re-exported here with
`boundary_face_counts` under the JAX package's names).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from pffdtd_tpu_torch.io.simdata import SimData, read_sim_folder
from pffdtd_tpu_torch.scene import (boundary_face_counts, fold_fcc_sim,
                                    orientation_scores, rotate_sim,
                                    sort_sim)

__all__ = ["copy_sim_data", "rotate_sim_data", "fold_fcc_sim_data",
           "sort_sim_data", "rotate_sim", "fold_fcc_sim", "sort_sim",
           "boundary_face_counts", "orientation_scores"]


def copy_sim_data(src, dst):
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    for f in Path(src).glob("*.h5"):
        shutil.copy(f, dst)


def _store(folder, sim: SimData):
    import h5py

    with h5py.File(Path(folder) / "vox_out.h5", "r+") as f:
        f["bn_ixyz"][...] = sim.vox.bn_ixyz
        f["adj_bn"][...] = sim.vox.adj_bn
        f["mat_bn"][...] = sim.vox.mat_bn
        f["saf_bn"][...] = sim.vox.saf_bn
        f["Nx"][()] = sim.vox.Nx
        f["Ny"][()] = sim.vox.Ny
        f["Nz"][()] = sim.vox.Nz
        for name, v in (("xv", sim.vox.xv), ("yv", sim.vox.yv),
                        ("zv", sim.vox.zv)):
            del f[name]
            f.create_dataset(name, data=v)
    with h5py.File(Path(folder) / "comms_out.h5", "r+") as f:
        f["in_ixyz"][...] = sim.comms.in_ixyz
        f["in_sigs"][...] = sim.comms.in_sigs
        f["out_ixyz"][...] = sim.comms.out_ixyz
        f["out_reorder"][...] = sim.comms.out_reorder
    with h5py.File(Path(folder) / "sim_consts.h5", "r+") as f:
        f["fcc_flag"][()] = np.int8(sim.consts.fcc_flag)


def rotate_sim_data(folder, tr=None):
    """Rotate a sim folder by "auto" (`scene.rotate_sim`), or by the
    permutation `tr`."""
    _store(folder, rotate_sim(read_sim_folder(folder), tr=tr))


def fold_fcc_sim_data(folder):
    _store(folder, fold_fcc_sim(read_sim_folder(folder)))


def sort_sim_data(folder):
    _store(folder, sort_sim(read_sim_folder(folder)))
