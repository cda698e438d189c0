"""Sim-folder data: numpy-only dataclasses (`simdata`), the HDF5 readers
and writers and the lazy `SimFolder` handle (`h5`, h5py imported when one
reads or writes); every name that pffdtd_tpu.io exports, and
`SimData` and `read_sim_folder`."""

from pffdtd_tpu_torch.io.simdata import (  # noqa: F401
    MMb,
    CommsData,
    MatsData,
    SimConstsData,
    SimData,
    VoxData,
    read_sim_folder,
)
from pffdtd_tpu_torch.io.h5 import (  # noqa: F401
    SimFolder,
    read_cart_grid,
    read_mat_file,
    read_comms,
    read_consts,
    read_mats,
    read_outputs,
    read_vox,
    write_comms,
    write_mats,
    write_outputs,
    write_vox,
)
