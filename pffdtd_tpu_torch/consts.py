"""Simulation constants: sound speed, Courant numbers, grid spacing, rate.

Copy of `SimConsts` and `speed_of_sound` from pffdtd_tpu/consts.py; `save`
writes sim_consts.h5 (h5py imported inside it).  lambda^2 = 1/3 (7-pt
Cartesian) or 1 (13-pt FCC), backed off by 0.999 in lambda to suppress the
Nyquist mode.  Exactly one of (h,), (SR,), (fmax, PPW) sets the spacing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


def speed_of_sound(Tc: float) -> float:
    """c = 343.2*sqrt(T_kelvin-ish ratio), the reference's convention."""
    return 343.2 * np.sqrt(Tc / 20.0)


@dataclass
class SimConsts:
    Tc: float = 20.0      # temperature, deg C
    rh: float = 50.0      # relative humidity, %
    h: float | None = None      # grid spacing, m
    SR: float | None = None     # sample rate, Hz
    fmax: float | None = None   # max usable frequency, Hz
    PPW: float | None = None    # points per wavelength at fmax
    fcc: bool = False

    c: float = field(init=False)
    Ts: float = field(init=False)
    l: float = field(init=False)
    l2: float = field(init=False)

    def __post_init__(self):
        assert -20 <= self.Tc <= 50
        assert 10 <= self.rh <= 100
        c = speed_of_sound(self.Tc)

        l2 = 1.0 if self.fcc else 1.0 / 3.0
        l = np.sqrt(l2)
        l *= 0.999  # remove the Nyquist mode
        l2 = l * l

        if self.h is not None:
            h = self.h
            Ts = h / c * l
            SR = 1.0 / Ts
        elif self.SR is not None:
            SR = self.SR
            Ts = 1.0 / SR
            h = c * Ts / l
        elif self.fmax is not None and self.PPW is not None:
            h = c / (self.fmax * self.PPW)
            Ts = h / c * l
            SR = 1.0 / Ts
        else:
            raise ValueError("need h, SR, or (fmax and PPW)")

        self.c = float(c)
        self.h = float(h)
        self.Ts = float(Ts)
        self.SR = float(SR)
        self.l = float(l)
        self.l2 = float(l2)

    @property
    def fcc_flag(self) -> int:
        return int(self.fcc)

    def save(self, save_folder):
        """Write sim_consts.h5 (dataset names/dtypes per the reference format)."""
        import h5py

        folder = Path(save_folder)
        folder.mkdir(parents=True, exist_ok=True)
        with h5py.File(folder / "sim_consts.h5", "w") as f:
            f.create_dataset("c", data=np.float64(self.c))
            f.create_dataset("h", data=np.float64(self.h))
            f.create_dataset("Ts", data=np.float64(self.Ts))
            f.create_dataset("SR", data=np.float64(self.SR))
            f.create_dataset("l", data=np.float64(self.l))
            f.create_dataset("l2", data=np.float64(self.l2))
            f.create_dataset("fcc_flag", data=np.int8(self.fcc_flag))
            f.create_dataset("Tc", data=np.float64(self.Tc))
            f.create_dataset("rh", data=np.float64(self.rh))
