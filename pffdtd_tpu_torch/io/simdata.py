"""The sim-folder data contract, as numpy-only dataclasses.

Counterpart of the dataclasses in `pffdtd_tpu/io/h5.py` and of `SimData`
in `pffdtd_tpu/scene_setup.py`, with the same fields.  The engine reads
them by attribute, so the JAX package's own objects work too.

HDF5 is touched only by `read_sim_folder` and `write_outputs`, through the
port's own `io/h5.py` (a copy of the reference's reader and writer, so the
files stay byte-compatible), which imports `h5py` only when called.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MMb = 12  # max RLC branches per material (pffdtd_tpu/io/h5.py:30)


@dataclass
class SimConstsData:
    c: float
    h: float
    Ts: float
    SR: float
    l: float
    l2: float
    fcc_flag: int
    Tc: float = 20.0
    rh: float = 50.0

    @property
    def fcc(self) -> bool:
        return self.fcc_flag > 0


@dataclass
class CommsData:
    in_ixyz: np.ndarray      # (Ns,) i64
    out_ixyz: np.ndarray     # (Nr,) i64
    out_alpha: np.ndarray    # (Nr/8, 8) f64 trilinear weights
    out_reorder: np.ndarray  # (Nr,) i64
    in_sigs: np.ndarray      # (Ns, Nt) f64
    diff: bool

    @property
    def Ns(self) -> int:
        return int(self.in_ixyz.size)

    @property
    def Nr(self) -> int:
        return int(self.out_ixyz.size)

    @property
    def Nt(self) -> int:
        return int(self.in_sigs.shape[-1])


@dataclass
class VoxData:
    Nx: int
    Ny: int
    Nz: int
    bn_ixyz: np.ndarray   # (Nb,) i64
    adj_bn: np.ndarray    # (Nb, NN) bool
    mat_bn: np.ndarray    # (Nb,) i8, -1 = rigid
    saf_bn: np.ndarray    # (Nb,) f64
    xv: np.ndarray
    yv: np.ndarray
    zv: np.ndarray
    h: float

    @property
    def Nb(self) -> int:
        return int(self.bn_ixyz.size)

    @property
    def NN(self) -> int:
        return int(self.adj_bn.shape[1]) if self.adj_bn.ndim == 2 else 6


@dataclass
class MatsData:
    Nmat: int
    Mb: np.ndarray    # (Nmat,) i8
    DEF: np.ndarray   # (Nmat, MMb, 3) f64, zero-padded past Mb[i]


@dataclass
class SimData:
    """In-memory equivalent of a sim folder."""

    consts: SimConstsData
    vox: VoxData
    comms: CommsData
    mats: MatsData


def read_sim_folder(folder) -> SimData:
    """Read the four engine inputs of a sim folder (needs h5py), through
    `h5.SimFolder`."""
    from pffdtd_tpu_torch.io.h5 import SimFolder

    sf = SimFolder(folder)
    return SimData(consts=sf.consts, vox=sf.vox, comms=sf.comms,
                   mats=sf.mats)


def write_outputs(folder, u_out, out_reorder=None):
    """Write sim_outs.h5 with u_out in receiver order (needs h5py)."""
    from pffdtd_tpu_torch.io import h5

    h5.write_outputs(folder, u_out, out_reorder)
