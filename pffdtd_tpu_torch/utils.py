"""Small helpers: copies of `iceil`, `iround`, `ind2sub3d`, `sub2ind3d`
(row-major x, y, z with z contiguous), `rel_diff` and `wavwrite` from
pffdtd_tpu/utils/__init__.py."""

from __future__ import annotations

import numpy as np


def iceil(x) -> np.int_:
    return np.int_(np.ceil(x))


def iround(x) -> np.int_:
    return np.int_(np.round(x))


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


def rel_diff(x0, x1):
    """Difference normalised to the binary exponent of x0 (machine-eps units).

    Zero entries of x0 (e.g. the first step's E_in before any input energy)
    normalise by 2^0, i.e. degrade to the raw difference instead of inf/nan.
    """
    ax = np.abs(np.asarray(x0, np.float64))
    expo = np.where(ax > 0, np.floor(np.log2(np.where(ax > 0, ax, 1.0))), 0.0)
    return (x0 - x1) / (2.0 ** expo)


def wavwrite(fname, sr: int, data):
    """Write float32 WAV; data is (Nchannels, Nsamples) or (Nsamples,)."""
    import scipy.io.wavfile

    data = np.atleast_2d(data)
    scipy.io.wavfile.write(fname, int(sr), np.float32(data.T))
