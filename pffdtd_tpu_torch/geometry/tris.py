"""Batched triangle precompute as a struct-of-arrays dataclass.

Copy of `TriPre` and `tris_precompute` from pffdtd_tpu/geometry/tris.py,
held array-for-array equal to them (tests/test_torch_setup.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pffdtd_tpu_torch.utils import normalise, vecnorm


@dataclass
class TriPre:
    """Precomputed quantities for N triangles; every field is (N, ...)"""

    v: np.ndarray          # (N, 3, 3) vertices a,b,c
    cent: np.ndarray       # (N, 3) centroid
    nor: np.ndarray        # (N, 3) area-scaled normal
    unor: np.ndarray       # (N, 3) unit normal
    eab_unor: np.ndarray   # (N, 3) outward unit normal of edge ab (in tri plane)
    ebc_unor: np.ndarray   # (N, 3)
    eca_unor: np.ndarray   # (N, 3)
    bmin: np.ndarray       # (N, 3) bbox min
    bmax: np.ndarray       # (N, 3) bbox max
    area: np.ndarray       # (N,)

    def __len__(self) -> int:
        return self.v.shape[0]

    def select(self, idx) -> "TriPre":
        return TriPre(**{k: getattr(self, k)[idx] for k in self.__dataclass_fields__})


def tris_precompute(pts: np.ndarray, tris: np.ndarray) -> TriPre:
    """Precompute per-triangle geometry for intersection predicates.

    pts: (Npts, 3) float64; tris: (Ntris, 3) int vertex indices.
    """
    pts = np.asarray(pts, np.float64)
    tris = np.asarray(tris, np.int64)
    a, b, c = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]

    ab, bc, ca = b - a, c - b, a - c
    cent = (a + b + c) / 3.0
    # area-scaled normal, averaged over the three vertex cross products for
    # robustness to near-degenerate triangles
    nor = (np.cross(ab, -ca) + np.cross(bc, -ab) + np.cross(ca, -bc)) / 3.0
    area = 0.5 * vecnorm(nor)
    unor = normalise(nor)

    return TriPre(
        v=np.stack([a, b, c], axis=1),
        cent=cent,
        nor=nor,
        unor=unor,
        eab_unor=normalise(np.cross(ab, nor)),
        ebc_unor=normalise(np.cross(bc, nor)),
        eca_unor=normalise(np.cross(ca, nor)),
        bmin=np.minimum(np.minimum(a, b), c),
        bmax=np.maximum(np.maximum(a, b), c),
        area=area,
    )
