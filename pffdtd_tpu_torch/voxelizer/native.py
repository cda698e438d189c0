"""ctypes bridge to the native C++/OpenMP voxelizer backend.

The port's own bridge to the repo's `native/voxelizer.cpp` (the source the
JAX package's `pffdtd_tpu/voxelizer/native.py` builds), with the same
`pack_tris` layout and `calc_adj(vox_scene, block_size)` contract: the
boundary arrays bn_ixyz, adj_bn, tidx_bn and ndist_bn, sorted by linear
index.  The source is only read: g++ compiles it at first use into
`pffdtd_tpu_torch/_build/` (listed in .gitignore), never under `native/`.
The library's name carries a hash of the source, the flags and the host,
so a changed source is rebuilt, and a checkout copied to another machine
does not load a build made for another CPU (`-march=native`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

from pffdtd_tpu_torch.spans import span

PKG = Path(__file__).resolve().parents[1]
SRC = PKG.parent / "native" / "voxelizer.cpp"
BUILD = PKG / "_build"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_lib = None


def lib_path() -> Path:
    """Where the build of the current source goes on this host."""
    h = hashlib.sha256(" ".join(FLAGS + [platform.node(),
                                         platform.machine()]).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"libpffdtd_vox_{h.hexdigest()[:16]}.so"


def build(path: Path) -> Path:
    """Compile the source into `path` (written beside it, then renamed)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native voxelizer needs a C++ "
                           "compiler with OpenMP")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({r.returncode}) on {SRC.name}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    return path


def load():
    """Build (once per source, flags and host) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    lib.vox_calc_adj.restype = ctypes.c_int64
    lib.vox_calc_adj.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,                     # tris, Ntris
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # xv, yv, zv
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # Nx, Ny, Nz
        ctypes.c_double, ctypes.c_int,                       # h, fcc
        ctypes.c_void_p, ctypes.c_void_p,                    # adj_full, ndist
        ctypes.c_void_p, ctypes.c_void_p,                    # tidx, nb_flag
    ]
    _lib = lib
    return lib


def pack_tris(tp) -> np.ndarray:
    """Pack a TriPre into the (Ntris, 30) float64 layout the kernel expects."""
    return np.ascontiguousarray(np.concatenate([
        tp.v.reshape(len(tp), 9),
        tp.unor, tp.cent, tp.eab_unor, tp.ebc_unor, tp.eca_unor,
        tp.bmin, tp.bmax,
    ], axis=1), np.float64)


@span("vox.native")
def calc_adj(vs, block_size: int = 32):
    """Native adjacency computation for a VoxScene; returns the bn arrays."""
    lib = load()
    cg, rg = vs.cg, vs.rg
    Nx, Ny, Nz = cg.Nx, cg.Ny, cg.Nz
    NN = vs.NN
    tris = pack_tris(rg.tris_pre)

    full = np.uint16((1 << NN) - 1)
    adj_full = np.full(Nx * Ny * Nz, full, np.uint16)
    ndist = np.full(Nx * Ny * Nz, np.inf, np.float64)
    tidx = np.full(Nx * Ny * Nz, -1, np.int32)
    nb_flag = np.zeros(Nx * Ny * Nz, np.uint8)
    xv = np.ascontiguousarray(cg.xv, np.float64)
    yv = np.ascontiguousarray(cg.yv, np.float64)
    zv = np.ascontiguousarray(cg.zv, np.float64)

    lib.vox_calc_adj(
        tris.ctypes.data, tris.shape[0],
        xv.ctypes.data, yv.ctypes.data, zv.ctypes.data,
        Nx, Ny, Nz, float(cg.h), int(vs.fcc),
        adj_full.ctypes.data, ndist.ctypes.data,
        tidx.ctypes.data, nb_flag.ctypes.data)

    bn_ixyz = np.flatnonzero(adj_full != full).astype(np.int64)
    packed = adj_full[bn_ixyz]
    adj_bn = np.zeros((bn_ixyz.size, NN), bool)
    for k in range(NN):
        adj_bn[:, k] = (packed >> k) & 1
    return bn_ixyz, adj_bn, tidx[bn_ixyz], ndist[bn_ixyz]
