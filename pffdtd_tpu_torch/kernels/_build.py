"""Build the CUDA sources with nvcc and load them with ctypes.

All of `pffdtd_tpu_torch/csrc/*.cu` compile, in one nvcc call, into one
shared library with a plain C interface under `pffdtd_tpu_torch/_build/`
(listed in .gitignore).  The library's name carries a hash of the sources
and flags, so a checkout builds on first use and reuses the build after.
No PyTorch header is included, which keeps the build to seconds.

`-fmad=false` keeps nvcc from contracting a*b+c into one FMA: each kernel
then rounds every operation as its plain PyTorch version does, and the two
agree to the last bit or close to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_vp, _i, _ll, _d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
# C entry points: name -> argtypes (each returns cudaGetLastError() as int)
SIGNATURES = {
    # dtype(0=f32,1=f64), nn, u0, u1, adj, out, Nx, Ny, Nz, folded,
    # a2, sl2, lQ1, lQ2, lQ3, stream
    "pf_stencil_step": [_i, _i, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                        _d, _d, _d, _d, _d, _vp],
    # dtype, unew, u0, bnl, ssaf, mat, coef, beta, vh, gh, nbl, l, lo2,
    # stream
    "pf_boundary_update": [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                           _ll, _d, _d, _vp],
    # dtype, nn, tb, u0, u1, adj, out0, out1, Nx, Ny, Nz, folded, Bx, By,
    # Bz, a2, sl2, lQ1, lQ2, lQ3, l, lo2, tl_ptr, tl_node, tl_off, tl_ring,
    # ssaf, mat, coef, beta, vh_in, gh_in, vh_out, gh_out, nbl, src, sig,
    # ns, rcv, taps, nr, stream
    "pf_tb_sweep": [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                    _i, _i, _i, _d, _d, _d, _d, _d, _d, _d, _vp, _vp, _vp,
                    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _vp,
                    _vp, _i, _vp, _vp, _i, _vp],
    # mode (0 read, 1 write, 2 copy), x, y, n, value, partial, out, stream
    "pf_stream": [_i, _vp, _vp, _ll, _d, _vp, _vp, _vp],
    # () -> blocks each pf_stream mode launches
    "pf_stream_blocks": [],
}


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


_LIB: KernelLibrary | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD / f"libpffdtd_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    _LIB = KernelLibrary(so, time.perf_counter() - t0, log)
    return _LIB


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
