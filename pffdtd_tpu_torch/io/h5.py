"""The HDF5 sim-folder reader and output writer of the port.

Copy of `read_consts`, `read_vox`, `read_comms`, `read_mats`,
`write_outputs` and `read_outputs` from pffdtd_tpu/io/h5.py (the file
contract of the reference: dataset names, dtypes and shapes are the same, so
the files stay byte-compatible).  They return the port's numpy-only
dataclasses.  `h5py` is imported inside each function: the card's machine
may lack it, and nothing on the engine's path needs it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pffdtd_tpu_torch.io.simdata import (MMb, CommsData, MatsData,
                                         SimConstsData, VoxData)


def read_consts(folder) -> SimConstsData:
    import h5py

    with h5py.File(Path(folder) / "sim_consts.h5", "r") as f:
        kw = {k: f[k][()] for k in ("c", "h", "Ts", "SR", "l", "l2",
                                    "fcc_flag")}
        for k in ("Tc", "rh"):
            if k in f:
                kw[k] = f[k][()]
    kw["fcc_flag"] = int(kw["fcc_flag"])
    return SimConstsData(**{k: (float(v) if k != "fcc_flag" else v)
                            for k, v in kw.items()})


def read_comms(folder) -> CommsData:
    import h5py

    with h5py.File(Path(folder) / "comms_out.h5", "r") as f:
        return CommsData(
            in_ixyz=f["in_ixyz"][...].astype(np.int64),
            out_ixyz=f["out_ixyz"][...].reshape(-1).astype(np.int64),
            out_alpha=f["out_alpha"][...],
            out_reorder=f["out_reorder"][...].astype(np.int64),
            in_sigs=np.atleast_2d(f["in_sigs"][...]),
            diff=bool(f["diff"][()]) if "diff" in f else False,
        )


def read_vox(folder) -> VoxData:
    import h5py

    with h5py.File(Path(folder) / "vox_out.h5", "r") as f:
        return VoxData(
            Nx=int(f["Nx"][()]),
            Ny=int(f["Ny"][()]),
            Nz=int(f["Nz"][()]),
            bn_ixyz=f["bn_ixyz"][...].astype(np.int64),
            adj_bn=f["adj_bn"][...].astype(bool),
            mat_bn=f["mat_bn"][...].astype(np.int8),
            saf_bn=f["saf_bn"][...].astype(np.float64),
            xv=f["xv"][...],
            yv=f["yv"][...],
            zv=f["zv"][...],
            h=float(f["h"][()]),
        )


def read_mats(folder) -> MatsData:
    import h5py

    with h5py.File(Path(folder) / "sim_mats.h5", "r") as f:
        Nmat = int(f["Nmat"][()])
        Mb = (f["Mb"][...].astype(np.int8) if Nmat > 0
              else np.zeros((0,), np.int8))
        DEF = np.zeros((Nmat, MMb, 3), np.float64)
        for i in range(Nmat):
            d = f[f"mat_{i:02d}_DEF"][...]
            assert d.shape == (Mb[i], 3)
            assert Mb[i] <= MMb
            DEF[i, : Mb[i]] = d
    return MatsData(Nmat=Nmat, Mb=Mb, DEF=DEF)


def write_outputs(folder, u_out, out_reorder=None):
    """Write sim_outs.h5 with u_out reordered to receiver order."""
    import h5py

    u_out = np.asarray(u_out, np.float64)
    if out_reorder is not None:
        u_out = u_out[np.asarray(out_reorder)]
    with h5py.File(Path(folder) / "sim_outs.h5", "w") as f:
        f.create_dataset("u_out", data=u_out)


def read_outputs(folder) -> np.ndarray:
    import h5py

    with h5py.File(Path(folder) / "sim_outs.h5", "r") as f:
        return f["u_out"][...]
