"""Neighbour direction vectors, ordered in (+, -) opposite pairs: copy of
`CART_VECTORS` and `FCC_VECTORS` from pffdtd_tpu/voxelizer/vox.py.  Bit k of
a packed adjacency mask belongs to leg k of these tables."""

import numpy as np

CART_VECTORS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float64)
FCC_VECTORS = np.array(
    [[+1, +1, 0], [-1, -1, 0], [0, +1, +1], [0, -1, -1], [+1, 0, +1],
     [-1, 0, -1], [+1, -1, 0], [-1, +1, 0], [0, +1, -1], [0, -1, +1],
     [+1, 0, -1], [-1, 0, +1]],
    np.float64)
