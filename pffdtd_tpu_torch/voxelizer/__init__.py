"""The grid and the neighbour vectors (copies from pffdtd_tpu.voxelizer)."""
