"""Room geometry: scene loading, materials, areas, volume.

Copy of `RoomGeo` from pffdtd_tpu/geometry/room.py.  The model JSON schema
is {mats_hash: {name: {pts, tris, sides, color}}, sources, receivers};
materials sort alphabetically with '_RIGID' forced last and given index
-1; optional az/el scene rotation; degenerate-triangle pruning;
per-material areas honouring sidedness; volume by the divergence theorem.
`RoomGeo.from_arrays` builds one from triangle soup.
"""

from __future__ import annotations

import json

import numpy as np

from pffdtd_tpu_torch.geometry.tris import tris_precompute
from pffdtd_tpu_torch.utils import dotv, rotate_az_el_deg


class RoomGeo:
    def __init__(self, json_file=None, az_el=(0.0, 0.0), area_eps=1e-6,
                 bmin=None, bmax=None):
        self.area_eps = area_eps
        self.R, _, _ = rotate_az_el_deg(*az_el)
        self.bmin = np.full(3, np.inf) if bmin is None else np.asarray(bmin, np.float64)
        self.bmax = -np.full(3, np.inf) if bmax is None else np.asarray(bmax, np.float64)
        self._custom_bounds = bmin is not None and bmax is not None
        if json_file is not None:
            self._load_json(json_file)
            self._finalise()

    # ------------------------------------------------------------------ build
    @classmethod
    def from_arrays(cls, pts, tris, mat_ind, mat_side, mat_str, Sxyz, Rxyz,
                    colors=None, area_eps=1e-6):
        """Build directly from triangle soup (synthetic scenes, tests)."""
        rg = cls.__new__(cls)
        rg.area_eps = area_eps
        rg.R = np.eye(3)
        rg.pts = np.asarray(pts, np.float64)
        rg.tris = np.asarray(tris, np.int64)
        rg.mat_ind = np.asarray(mat_ind, np.int8)
        rg.mat_side = np.asarray(mat_side, np.int8)
        rg.mat_str = list(mat_str)
        rg.Nmat = len([m for m in rg.mat_str if m != "_RIGID"])
        rg.colors = colors or [(128, 128, 128)] * len(rg.mat_str)
        rg.Sxyz = np.atleast_2d(np.asarray(Sxyz, np.float64))
        rg.Rxyz = np.atleast_2d(np.asarray(Rxyz, np.float64))
        rg.bmin = rg.pts.min(0)
        rg.bmax = rg.pts.max(0)
        rg._custom_bounds = False
        rg._finalise()
        return rg

    def _load_json(self, json_file):
        with open(json_file) as f:
            data = json.load(f)

        mats_dict = data["mats_hash"]
        mat_str = sorted(mats_dict.keys())
        Nmat = len(mat_str)
        if "_RIGID" in mat_str:
            mat_str.remove("_RIGID")
            mat_str.append("_RIGID")  # always last; boundary index -1
            Nmat -= 1

        R = self.R
        pts_list, tris_list, side_list, ind_list, colors = [], [], [], [], []
        off = 0
        bmin, bmax = self.bmin.copy(), self.bmax.copy()
        for i, mat in enumerate(mat_str):
            p = np.asarray(mats_dict[mat]["pts"], np.float64) @ R
            t = np.asarray(mats_dict[mat]["tris"], np.int64)
            pts_list.append(p)
            tris_list.append(t + off)
            side_list.append(np.asarray(mats_dict[mat]["sides"], np.int8))
            ind = np.full(t.shape[0], i, np.int8)
            ind_list.append(ind)
            colors.append(tuple(mats_dict[mat].get("color", (128, 128, 128))))
            off += p.shape[0]
            bmin = np.minimum(bmin, p.min(0))
            bmax = np.maximum(bmax, p.max(0))

        self.pts = np.concatenate(pts_list, axis=0)
        self.tris = np.concatenate(tris_list, axis=0)
        self.mat_side = np.concatenate(side_list, axis=0)
        mat_ind = np.concatenate(ind_list, axis=0)
        mat_ind[mat_ind == Nmat] = -1  # the '_RIGID' group
        self.mat_ind = mat_ind
        self.mat_str = mat_str
        self.Nmat = Nmat
        self.colors = colors
        self.bmin, self.bmax = bmin, bmax

        assert len(data["sources"]) > 0
        assert len(data["receivers"]) > 0
        Sxyz = np.atleast_2d(np.asarray([s["xyz"] for s in data["sources"]], np.float64)) @ R
        Rxyz = np.atleast_2d(np.asarray([r["xyz"] for r in data["receivers"]], np.float64)) @ R
        assert np.all((Sxyz > bmin) & (Sxyz < bmax))
        assert np.all((Rxyz > bmin) & (Rxyz < bmax))
        self.Sxyz, self.Rxyz = Sxyz, Rxyz

        assert np.all(self.mat_side[self.mat_ind == -1] == 0)

    def _finalise(self):
        self.tris_pre = tris_precompute(self.pts, self.tris)
        self._prune_by_area()
        self._calc_areas()
        self._calc_volume()

    def _prune_by_area(self):
        keep = self.tris_pre.area >= self.area_eps
        n_del = int((~keep).sum())
        if n_del:
            self.tris = self.tris[keep]
            self.mat_ind = self.mat_ind[keep]
            self.mat_side = self.mat_side[keep]
            self.tris_pre = self.tris_pre.select(keep)

    def _calc_areas(self):
        """Per-material surface area honouring sidedness (3 = both sides -> 2x)."""
        area = np.zeros(self.Nmat, np.float64)
        for i in range(self.Nmat):
            ii = self.mat_ind == i
            sides = self.mat_side[ii]
            fac = np.where(sides == 3, 2.0, np.where(sides > 0, 1.0, 0.0))
            area[i] = np.sum(self.tris_pre.area[ii] * fac)
        self.mat_area = area

    def _calc_volume(self):
        tp = self.tris_pre
        self.vol = np.sum(dotv(tp.cent, tp.nor)) / 6.0
        self.area = np.sum(tp.area)

    # ------------------------------------------------------------------ info
    def print_stats(self):
        print(f"--ROOM_GEO: npts={self.pts.shape[0]} ntris={self.tris.shape[0]}")
        print(f"--ROOM_GEO: bmin={self.bmin} bmax={self.bmax}")
        print(f"--ROOM_GEO: vol={self.vol:.3f} m^3, SA={self.area:.3f} m^2")
        for i in range(self.Nmat):
            print(f"--ROOM_GEO: mat {i}: {self.mat_str[i]}, {self.mat_area[i]:.3f} m^2")
