"""Update coefficients: scheme constants and material (RLC branch) transforms.

Counterpart of `pffdtd_tpu/engine/coeffs.py`, numpy only and held `==` to it:
- a1 = 2 - sl2*K, a2 = lfac*l2, sl2 = (1+EPS)*lfac*l2 with lfac = 0.25 (FCC)
  or 1 (Cartesian) and K = 12 or 6; EPS shifts the diagonal in fp32 so the
  discrete Laplacian stays negative semi-definite under rounding;
- per material, Dh = D/Ts, Eh = E, Fh = F*Ts, b = 1/(2Dh + Eh + Fh/2),
  bd = b*(2Dh - Eh - Fh/2), bDh = b*Dh, bFh = b*Fh, beta = sum_m b_m.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pffdtd_tpu_torch.io.simdata import MMb

FP32_EPS = 1.19209289e-07


@dataclass
class SchemeCoeffs:
    l: float
    l2: float
    lfac: float   # Laplacian prefactor: 0.25 FCC, 1 Cartesian
    K: int        # full neighbour count: 12 FCC, 6 Cartesian
    a1: float     # 2 - sl2*K (diagonal, with EPS shift in fp32)
    a2: float     # lfac*l2 (off-diagonal)
    sl2: float    # (1+EPS)*lfac*l2
    lo2: float    # l/2

    @classmethod
    def make(cls, l: float, l2: float, fcc: bool,
             eps: float = 0.0) -> "SchemeCoeffs":
        lfac = 0.25 if fcc else 1.0
        K = 12 if fcc else 6
        sl2 = (1.0 + eps) * lfac * l2
        return cls(l=l, l2=l2, lfac=lfac, K=K,
                   a1=2.0 - sl2 * K, a2=lfac * l2, sl2=sl2, lo2=0.5 * l)


@dataclass
class MatCoeffs:
    """Per-material branch coefficients, zero-padded to MMb branches.

    All arrays are (Nmat+1, MMb); row Nmat is the implicit rigid material
    (all-zero coefficients), so mat index -1 maps to it.
    """

    b: np.ndarray
    bd: np.ndarray
    bDh: np.ndarray
    bFh: np.ndarray
    beta: np.ndarray  # (Nmat+1,)
    D: np.ndarray     # raw DEF (for energy accounting)
    E: np.ndarray
    F: np.ndarray

    @classmethod
    def from_mats(cls, mats, Ts: float) -> "MatCoeffs":
        Nm = mats.Nmat
        shape = (Nm + 1, MMb)
        b, bd, bDh, bFh, D, E, F = (np.zeros(shape) for _ in range(7))
        for k in range(Nm):
            M = int(mats.Mb[k])
            Dk, Ek, Fk = mats.DEF[k, :M].T
            Dh, Eh, Fh = Dk / Ts, Ek, Fk * Ts
            bk = 1.0 / (2.0 * Dh + Eh + 0.5 * Fh)
            dk = 2.0 * Dh - Eh - 0.5 * Fh
            if not (np.all(np.isfinite(bk)) and np.all(np.isfinite(dk))):
                raise ValueError(f"material {k}: non-finite branch coefficients")
            b[k, :M] = bk
            bd[k, :M] = bk * dk
            bDh[k, :M] = bk * Dh
            bFh[k, :M] = bk * Fh
            D[k, :M], E[k, :M], F[k, :M] = Dk, Ek, Fk
        beta = b.sum(-1)
        if not np.all(beta >= 0):
            raise ValueError("negative branch admittance sum (beta)")
        return cls(b=b, bd=bd, bDh=bDh, bFh=bFh, beta=beta, D=D, E=E, F=F)

    def gather(self, mat_bnl: np.ndarray):
        """Per-node coefficient rows; mat index -1 maps to the rigid row."""
        idx = np.where(mat_bnl < 0, self.b.shape[0] - 1, mat_bnl)
        return {name: getattr(self, name)[idx]
                for name in ("b", "bd", "bDh", "bFh", "beta", "D", "E", "F")}

    def table(self, dtype) -> np.ndarray:
        """(Nmat+1, 4, MMb) stack of b | bd | bDh | bFh, the K2 lookup table."""
        return np.stack([self.b, self.bd, self.bDh, self.bFh], 1).astype(dtype)
