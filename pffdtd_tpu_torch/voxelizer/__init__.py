"""The grid, the voxelizer and its native backend (copies from
pffdtd_tpu.voxelizer)."""

from pffdtd_tpu_torch.voxelizer.grid import CartGrid  # noqa: F401
from pffdtd_tpu_torch.voxelizer.vox import (  # noqa: F401
    NEIGHBOR_VECTORS, VoxScene)
