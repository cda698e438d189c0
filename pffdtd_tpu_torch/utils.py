"""Index helpers: copy of `iceil`, `ind2sub3d` and `sub2ind3d` from
pffdtd_tpu/utils/__init__.py (row-major x, y, z with z contiguous)."""

from __future__ import annotations

import numpy as np


def iceil(x) -> np.int_:
    return np.int_(np.ceil(x))


def ind2sub3d(ii, Nx, Ny, Nz):
    """Linear index -> (ix, iy, iz) with z contiguous (row-major x,y,z)."""
    ii = np.asarray(ii)
    iz = ii % Nz
    iy = (ii // Nz) % Ny
    ix = ii // (Ny * Nz)
    return ix, iy, iz


def sub2ind3d(ix, iy, iz, Nx, Ny, Nz):
    """(ix, iy, iz) -> linear index with z contiguous."""
    return (np.asarray(ix) * Ny + np.asarray(iy)) * Nz + np.asarray(iz)
