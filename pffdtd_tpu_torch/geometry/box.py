"""Rotatable box primitive: copy of `Box` and `rotmatrix_ax_ang` from
pffdtd_tpu/geometry/box.py.

A box with optional axis-angle rotation and shift, exposing corner
vertices, edge / triangle / quad index lists, the halfspace form A x <= b
and the AABB; draw() renders with matplotlib (imported inside).
"""

from __future__ import annotations

import numpy as np

_EDGES = np.array([[0, 1], [0, 2], [0, 4], [1, 3], [1, 5], [2, 3],
                   [2, 6], [4, 5], [4, 6], [3, 7], [5, 7], [6, 7]])
_TRIS = np.array([[0, 1, 3], [0, 3, 2], [1, 7, 3], [1, 5, 7],
                  [0, 2, 6], [0, 6, 4], [4, 7, 5], [4, 6, 7],
                  [2, 3, 7], [2, 7, 6], [0, 5, 1], [0, 4, 5]])
_QUADS = np.array([[0, 1, 3, 2], [0, 4, 5, 1], [4, 6, 7, 5],
                   [1, 5, 7, 3], [2, 3, 7, 6], [0, 2, 6, 4]])


def rotmatrix_ax_ang(axis, angle_deg: float) -> np.ndarray:
    """Rotation matrix about `axis` by `angle_deg` (Rodrigues)."""
    ax = np.asarray(axis, np.float64)
    n = np.linalg.norm(ax)
    if n == 0:
        return np.eye(3)
    x, y, z = ax / n
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer((x, y, z), (x, y, z))


class Box:
    """Axis-angle-rotated, shifted box (unit cube by default)."""

    def __init__(self, Lx=1.0, Ly=1.0, Lz=1.0, Rax=(1.0, 1.0, 1.0),
                 Rang=0.0, shift=(0.0, 0.0, 0.0), centered=True):
        self.centered = bool(centered)
        self.init(Lx, Ly, Lz, Rax, Rang, np.asarray(shift, np.float64))

    def init(self, Lx, Ly, Lz, Rax, Rang, shift):
        L = np.array([Lx, Ly, Lz], np.float64)
        verts = np.array([[x, y, z] for x in (0, Lx) for y in (0, Ly)
                          for z in (0, Lz)], np.float64)
        # outward face normals and offsets of the UNROTATED box
        A = np.array([[-1., 0, 0], [0, -1., 0], [0, 0, -1.],
                      [1., 0, 0], [0, 1., 0], [0, 0, 1.]])
        if self.centered:
            verts -= 0.5 * L
            b = np.r_[0.5 * L, 0.5 * L]
        else:
            b = np.r_[np.zeros(3), L]
        R = rotmatrix_ax_ang(Rax, Rang)
        verts = verts @ R.T + shift
        A = A @ R.T
        b = b + A @ shift
        self.A, self.b = A, b
        self.verts = verts
        self.bmin = verts.min(0)
        self.bmax = verts.max(0)
        self.edges, self.tris, self.quads = _EDGES, _TRIS, _QUADS
        self.L = L

    def contains(self, pts, eps: float = 0.0) -> np.ndarray:
        """Boolean mask: points inside the (rotated) box, tol eps."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        return np.all(pts @ self.A.T <= self.b + eps, axis=-1)

    def randomise(self, rng=None):
        rng = np.random.default_rng(rng)
        self.init(*(10 * rng.random(3)), rng.random(3),
                  (2 * rng.random() - 1) * 90, 2 * rng.random(3) - 1)
        return self

    def draw(self, ax=None, color=(0, 0.7, 0), fname=None):
        """Edge wireframe via matplotlib (reference draws with mayavi)."""
        import matplotlib

        if fname is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        fig = None
        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
        ax.add_collection3d(Line3DCollection(self.verts[self.edges],
                                             colors=[color]))
        lo, hi = self.bmin.min(), self.bmax.max()
        ax.set_xlim(lo, hi), ax.set_ylim(lo, hi), ax.set_zlim(lo, hi)
        if fname is not None and fig is not None:
            fig.savefig(fname, dpi=100)
            plt.close(fig)
        return ax
