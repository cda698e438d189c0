"""Scene interchange: model_export.json writing and sources/receivers CSVs.

Copy of `read_positions_csv`, `write_model_json` and `room_to_model_json`
from pffdtd_tpu/geometry/scene_io.py: a scene dict written in the schema
{mats_hash: {name: {pts, tris, sides, color}}, sources, receivers} that
`RoomGeo` reads, and CSV position files read with any of the delimiters
",", ";", tab or space.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def read_positions_csv(path):
    """Read an (N, 3) position list from CSV with delimiter sniffing."""
    path = Path(path)
    text = path.read_text().strip()
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # normalise every candidate delimiter (",", ";", tab, space) - more
        # robust than per-file sniffing when rows are inconsistent
        for d in (",", ";", "\t"):
            line = line.replace(d, " ")
        parts = line.split()
        try:
            rows.append([float(p) for p in parts[:3]])
        except ValueError:
            continue  # header line
    out = np.asarray(rows, np.float64)
    assert out.ndim == 2 and out.shape[1] == 3, f"bad positions file {path}"
    return out


def write_model_json(path, mats, sources, receivers):
    """Write model_export.json in the reference schema.

    mats: {name: dict(pts=(N,3), tris=(M,3), sides=(M,) int 0..3,
                      color=(3,) ints)}; sources/receivers: (N,3) arrays.
    Sides: 0 = rigid/unmarked, 1 = back side live, 2 = front, 3 = both
    (RoomExport.rb:96-112).
    """
    data = {"mats_hash": {}, "sources": [], "receivers": []}
    for name, m in mats.items():
        pts = np.asarray(m["pts"], np.float64)
        tris = np.asarray(m["tris"], np.int64)
        sides = np.asarray(m.get("sides", np.ones(len(tris))), np.int64)
        color = list(m.get("color", (128, 128, 128)))
        assert sides.size == tris.shape[0]
        data["mats_hash"][name] = {
            "pts": pts.tolist(),
            "tris": tris.tolist(),
            "sides": sides.tolist(),
            "color": color,
        }
    for i, s in enumerate(np.atleast_2d(sources)):
        data["sources"].append({"name": f"S{i + 1}", "xyz": list(map(float, s))})
    for i, r in enumerate(np.atleast_2d(receivers)):
        data["receivers"].append({"name": f"R{i + 1}",
                                  "xyz": list(map(float, r))})
    Path(path).write_text(json.dumps(data))
    return data


def room_to_model_json(path, room_geo):
    """Export a RoomGeo back to model_export.json (round-trip tooling)."""
    mats = {}
    for i, name in enumerate(room_geo.mat_str):
        idx = i if name != "_RIGID" else -1
        sel = room_geo.mat_ind == idx
        if not sel.any():
            continue
        tris = room_geo.tris[sel]
        used = np.unique(tris)
        remap = {int(p): k for k, p in enumerate(used)}
        mats[name] = {
            "pts": room_geo.pts[used],
            "tris": np.vectorize(remap.get)(tris),
            "sides": room_geo.mat_side[sel],
            "color": room_geo.colors[i] if i < len(room_geo.colors)
            else (128, 128, 128),
        }
    return write_model_json(path, mats, room_geo.Sxyz, room_geo.Rxyz)
