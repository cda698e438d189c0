"""Build the CUDA sources with nvcc and load them with ctypes.

Each of `pffdtd_tpu_torch/csrc/*.cu` compiles in its own nvcc process, all
started together, and the objects link into one shared library with a
plain C interface under `pffdtd_tpu_torch/_build/` (listed in .gitignore).
The library's name carries a hash of the sources, the headers they share
(`csrc/*.cuh`) and the flags, so a checkout builds on first use and reuses
the build after.  No PyTorch header is included, which keeps the build to
seconds.

`-fmad=false` keeps nvcc from contracting a*b+c into one FMA: each kernel
then rounds every operation as its plain PyTorch version does, and the two
agree to the last bit or close to it.  `-split-compile=0` optimizes the
template instances of one source on every core at once: tb.cu and
tb_shard.cu hold about eighty K3/K6 instances each (half of them the ABC
mode's), which one thread compiles in minutes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from pffdtd_tpu_torch.spans import span

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-split-compile=0", "-Xptxas", "-v"]

_vp, _i, _ll, _d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
_TB_ARGS = ([_i] * 3 + [_vp] * 5 + [_i] * 8 + [_d] * 7 + [_vp] * 4 + [_ll]
            + [_vp] * 9 + [_ll, _vp, _vp, _i, _vp, _vp, _i, _i, _vp])
# C entry points: name -> argtypes (each returns cudaGetLastError() as int)
SIGNATURES = {
    # dtype(0=f32,1=f64), nn, u0, u1, adj, out, Nx, Ny, Nz, folded,
    # By, Bz, Cx, a2, sl2, lQ1, lQ2, lQ3, stream
    "pf_stencil_step": [_i, _i, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                        _i, _i, _i, _d, _d, _d, _d, _d, _vp],
    # dtype, nn, u0, u1, mask, rows, base, legs, W, out, Nx, Ny, Nz,
    # folded, By, Bz, Cx, a2, sl2, lQ1, lQ2, lQ3, stream
    "pf_stencil_step_compact": [_i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _i,
                                _vp, _i, _i, _i, _i, _i, _i, _i, _d, _d, _d,
                                _d, _d, _vp],
    # dtype, nn, u0, u1, adj, out, Lu, part, npart, Nx, Ny, Nz, folded,
    # a2, sl2, lQ1, lQ2, lQ3, lfac, inv_l2, stream
    "pf_stencil_energy_step": [_i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _ll,
                               _i, _i, _i, _i, _d, _d, _d, _d, _d, _d, _d,
                               _vp],
    # dtype, nn, u0, u1, adj, out, Nx (global), Ny, Nz, folded, G, S, xo,
    # By, Bz, Cx, a2, sl2, lQ1, lQ2, lQ3, stream
    "pf_stencil_step_shard": [_i, _i, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                              _i, _i, _i, _i, _i, _i, _d, _d, _d, _d, _d,
                              _vp],
    # dtype, unew, u0, bnl, ssaf, mat, coef, beta, vh, gh, nbl, l, lo2,
    # abcq (or null), lQ1, lQ2, lQ3, stream
    "pf_boundary_update": [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                           _ll, _d, _d, _vp, _d, _d, _d, _vp],
    # dtype, nn, tb, u0, u1, adj, out0, out1, Nx, Ny, Nz, folded, Cx, By,
    # Bz, threads, a2, sl2, lQ1, lQ2, lQ3, l, lo2, tl_rptr, tl_node, tl_yz,
    # tl_ring, ne, scratch, ssaf, mat, coef, beta, vh_in, gh_in, vh_out,
    # gh_out, nbl, src, sig, ns, rcv, taps, nr, src_k2, abcq (or null),
    # stream
    "pf_tb_sweep": _TB_ARGS + [_vp],
    # pf_tb_sweep's arguments up to abcq (Nx the global extent), then the
    # local x ranges: owned rows [xa, xb), computable rows [xl, xh), the
    # offset xo, and the stream
    "pf_tb_sweep_shard": _TB_ARGS + [_i] * 5 + [_vp],
    # dtype, unew, u0, vh, vh_prev, gh_prev, ssaf, mat, def, in_ixyz, sig,
    # nbl, ns, part, npart, Nx, Ny, Nz, folded, Ts, cH, cH_lossy, cL_abc,
    # cL_lossy, cIn, H, E_lost, E_in, stream
    "pf_energy_boundary": [_i] + [_vp] * 10 + [_ll, _i, _vp, _ll]
                          + [_i] * 4 + [_d] * 6 + [_vp] * 4,
    # a1, a2, F1, F2, u, out, nch, Nt, q0, stream
    "pf_modal_recurrence": [_vp] * 6 + [_i, _i, _i, _vp],
    # mode (0 read, 1 write, 2 copy), x, y, n, value, partial, out, stream
    "pf_stream": [_i, _vp, _vp, _ll, _d, _vp, _vp, _vp],
    # n -> blocks pf_stream launches
    "pf_stream_blocks": [_ll],
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
    if _LIB is None:
        _LIB = _build_and_load()
    return _LIB


@span("kernels.library")
def _build_and_load() -> KernelLibrary:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD / f"libpffdtd_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD / f"{p.stem}.{tag}.o" for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        outs = [(p, pr.communicate()[0], pr.returncode)
                for p, pr in zip(srcs, procs)]
        log = "".join(out for _, out, _ in outs)
        bad = [f"{p.name} ({rc})" for p, _, rc in outs if rc != 0]
        if bad:
            raise RuntimeError(f"nvcc failed on {', '.join(bad)}:\n{log}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        for o in objs:
            o.unlink(missing_ok=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return KernelLibrary(so, time.perf_counter() - t0, log)


_CURRENT = contextlib.nullcontext()


def on_device(dev: torch.device):
    """The context a launch through ctypes on `dev`'s tensors runs in.

    The C entry points launch on the calling thread's current device, as
    any CUDA runtime call does, whatever card their pointers and stream
    belong to, and `cudaFuncSetAttribute` (K3/K6's shared memory above 48
    KB) sets the current card only.  On four H100s, K4 called with cuda:1's
    tensors from a thread on cuda:0 returned no error and left its output
    unwritten, and the next launch met an illegal address.  So on a card
    that is not the current one this makes `dev` current for the launch
    (`torch.cuda.device`), as PyTorch's own operators do for their
    tensors; on the current card it does nothing."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(dev)


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
