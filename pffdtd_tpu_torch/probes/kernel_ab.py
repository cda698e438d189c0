"""K1, K1e, K2 and K3 of this tree against another checkout's, on the card:

    python -m pffdtd_tpu_torch.probes.kernel_ab --base DIR [--kernels K1,K3]

DIR holds another checkout's `csrc/` files: `stencil.cu` and `energy.cu`
(K7's middle stage, which K1e calls) with `energy_sums.cuh` for K1 and
K1e, `boundary.cu` for K2, `tb.cu` and `tb_shard.cu` for K3 (and K6).  A
base whose K1 has no march (no tiles) or whose K2 or K3 has no ABC mode
is refused.  Both trees' sources are built by nvcc, with the kernels'
flags, into libraries of their own under `_build/probe/`.  For each
kernel:
1. the SASS of the instances that both trees have (K1's march, which K5
   shares, at every tile width; K1e; K2 without its ABC mode; K3 and K6
   without theirs, at every dtype, adjacency, TB and row width) is
   compared instruction for instruction;
2. the kernel is timed from both in turns (base, tree, tree, base, twice),
   fp32 and fp64: K1 and K1e on random fields at the headline cell's
   shapes (792 x 310 x 510, FCC, every leg set), K1 also at the benchmark
   cell's (1628 x 635 x 1048, FCC) and on the 1.049 Gvox Cartesian box
   (1288 x 1008 x 808, every leg set), K2 on the headline cell's lossy
   nodes (the 36 x 28 x 23 m folded-FCC box at h = 0.046: 1,169,067
   nodes) and K3 (TB = 3) on the headline cell, each from a seeded random
   state, after one call of each compared bit for bit (K1e: u^{n+1}, L
   u^n and its sums); K1 also on a box's adjacency (the surface of a box
   three points in from the halo flagged, with random legs), the base's
   K1 on the packed grid against this tree's on its compact form
   (`kernels.stencil.CompactAdj`, the step route's), bit for bit and in
   turns;
3. K2 and K3: on the same box without its top wall (its lossy nodes on the
   top ABC layer flagged), this tree's kernel in its ABC mode and without
   it on the same inputs, in turns (fp32).
Times are CUDA-event windows of 20 calls; each line prints every window and
the best.  Each library's build time is printed (the two trees' builds of
one kernel run one after the other, each on every core).  The first line
printed is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.kernels.stream import time_ms

SHAPE = (792, 310, 510)
# K1's shapes (grid, FCC): the headline, the benchmark cell, the Cartesian
# 1.049 Gvox box
K1_SHAPES = ((SHAPE, True), ((1628, 635, 1048), True),
             ((1288, 1008, 808), False))
REPS = 20
PROBE = _build.BUILD / "probe"
IN_TURNS = ("base", "tree", "tree", "base") * 2
# what a source must hold to be called with this tree's entries: K1's
# march (its tiles), K2's and K3's ABC modes (their Q array)
NEEDS = {"stencil.cu": "int Cx", "boundary.cu": "abcq", "tb.cu": "abcq"}
# the instances both trees have: (regex, the key's groups, the group of the
# mode left out or None, its value): K1's march (K1 and K5), (dtype, adj,
# legs, tile width); K1e (dtype, adj, legs); K2's dtype without the ABC
# mode; (dtype, adj, legs, TB, row width, shard) of K3 and K6 without
# theirs
K1_SASS = (r"stencil_step_kernelI([fd])([ht])Li(\d+)ELi(\d+)EE",
           (1, 2, 3, 4), None, None)
K1E_SASS = (r"stencil_energy_kernelI([fd])([ht])Li(\d+)E", (1, 2, 3), None,
            None)
K2_SASS = (r"boundary_update_kernelI([fd])(Lb([01])E)?", (1,), 3, "1")
K3_SASS = (r"tb_sweep_kernelI([fd])([ht])Li(\d+)ELi(\d+)ELi(\d+)ELb([01])E"
           r"(Lb([01])E)?", (1, 2, 3, 4, 5, 6), 8, "1")


def card_line():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


def sources(d: Path, names) -> dict:
    """{name: text} of the files `names` in d; refuses a source that lacks
    what this tree's entries call (`NEEDS`)."""
    out = {}
    for name in names:
        out[name] = (d / name).read_text()
        if NEEDS.get(name, "") not in out[name]:
            raise SystemExit(f"{d / name}: built before K1's march or K2's "
                             f"and K3's ABC modes; the probe calls only "
                             f"this tree's entry points")
    return out


def build_lib(name: str, srcs: dict, include: Path) -> ctypes.CDLL:
    """nvcc of `srcs` ({file name: source text}), one process a file, into
    _build/probe/<name>/lib.so; the C entries present get the kernels'
    argument types.  Prints the build's seconds."""
    t0 = time.perf_counter()
    d = PROBE / name
    d.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs = []
    procs = []
    for fname, text in srcs.items():
        (d / fname).write_text(text)
        objs.append(d / f"{Path(fname).stem}.o")
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(include), "-c", "-o",
             str(objs[-1]), str(d / fname)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(d / "lib.so"),
                    *map(str, objs)], check=True)
    print(f"[build] {name}: {', '.join(srcs)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn, args in _build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def sass(obj: Path, pattern) -> dict:
    """{key: instruction lines} of the kernels in `obj` whose name matches
    pattern = (regex, the key's groups, the mode's group, a value): those
    whose mode's group holds that value are left out (mode None: none)."""
    regex, keys, mode, skip = pattern
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                         text=True, check=True).stdout
    out = {}
    for block in txt.split("Function : ")[1:]:
        m = re.search(regex, block.splitlines()[0])
        if not m or (mode is not None and m.group(mode) == skip):
            continue
        out[m.group(*keys)] = [
            re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).split(";")[0].strip()
            for ln in block.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/",
                                                      ln)]
    return out


def compare_sass(what, pattern, base: Path, tree: Path, each=True):
    """Prints each instance's comparison (each=False: one line for all)."""
    sb, st = sass(base, pattern), sass(tree, pattern)
    if not sb:
        print(f"[sass] {what}: no instance in base ({len(st)} in tree)",
              flush=True)
        return
    same = [k for k in sorted(sb) if sb[k] == st.get(k)]
    if each:
        for key in sorted(sb):
            print(f"[sass] {what} {key}: {len(sb[key])} instructions in "
                  f"base, {len(st.get(key, []))} in tree, identical "
                  f"{sb[key] == st.get(key)}", flush=True)
    else:
        n = sum(len(v) for v in sb.values())
        print(f"[sass] {what}: {len(same)} of {len(sb)} instances "
              f"identical ({n} instructions in base); differing: "
              f"{sorted(set(sb) - set(same)) or 'none'}", flush=True)


def turns(calls: dict, order) -> dict:
    """{name: [ms a call of each window]}, the windows taken in `order`."""
    t = {k: [] for k in calls}
    for k in order:
        t[k].append(time_ms(calls[k], REPS))
    return t


def fmt(t: dict) -> str:
    return ", ".join(f"{k} {min(v):.4f} ms (windows "
                     f"{', '.join(f'{x:.4f}' for x in v)})"
                     for k, v in t.items())


class Fields:
    """Random fields of `shape` on the card, every leg of the adjacency set
    (FCC: 12 legs, uint16; else 6, uint8); K1's and K1e's calls on them
    from a library (K1e at SHAPE)."""

    def __init__(self, dtype, shape=SHAPE, fcc=True):
        g = torch.Generator(device="cuda").manual_seed(0)
        self.r = lambda: torch.randn(shape, generator=g, device="cuda",
                                     dtype=dtype)
        self.shape, self.nn = shape, 12 if fcc else 6
        self.code = 0 if dtype == torch.float32 else 1
        self.u0, self.u1, self.out = self.r(), self.r(), self.r()
        self.adj = torch.full(shape, (1 << self.nn) - 1, device="cuda",
                              dtype=torch.uint16 if fcc else torch.uint8)
        self.stream = torch.cuda.current_stream().cuda_stream

    def energy(self):
        """Lu and K7's scratch, made at the first K1e call."""
        if not hasattr(self, "Lu"):
            Nx, Ny, Nz = self.shape
            blocks = -(-(Nz - 2) // 128) * (Ny - 2) * (Nx - 2)
            self.Lu = self.r()
            self.part = torch.zeros(2 * blocks + 2048, dtype=torch.float64,
                                    device="cuda")
        return self.Lu, self.part

    def box(self):
        """The adjacency of a box's surface three points in from the halo:
        its points flagged with random legs (not all open), seeded; the
        rest air."""
        full = (1 << self.nn) - 1
        g = torch.Generator(device="cuda").manual_seed(1)
        adj = torch.full(self.shape, full, dtype=torch.int32, device="cuda")
        lo, hi = 4, [n - 5 for n in self.shape]
        box = adj[lo:hi[0] + 1, lo:hi[1] + 1, lo:hi[2] + 1]
        for a in range(3):
            for end in (0, -1):
                face = box.select(a, end)
                face.copy_(torch.randint(0, full, face.shape, generator=g,
                                         device="cuda", dtype=torch.int32))
        self.adj = adj.to(self.adj.dtype)

    def k1(self, lib, out=None, compact=None):
        """K1 of `lib` into `out` (default self.out) on the tiles `plan_k1`
        gives, on the packed grid or on `compact`, its CompactAdj."""
        from pffdtd_tpu_torch.kernels.stencil import plan_k1

        p = lambda t: t.data_ptr()
        Nx, Ny, Nz = self.shape
        geo = plan_k1(Nx - 2, Ny, Nz, self.u1.element_size())
        rest = (*self.shape, 1, geo.By, geo.Bz, geo.Cx, 0.25, 3.0, 0.57,
                1.14, 1.71, self.stream)
        o = p(self.out if out is None else out)
        if compact is not None:
            c = compact
            args = (self.code, self.nn, p(self.u0), p(self.u1), p(c.mask),
                    p(c.rows), p(c.base), p(c.legs), c.mask.shape[2], o,
                    *rest)
            return lambda: _build.check(lib.pf_stencil_step_compact(*args),
                                        "K1")
        args = (self.code, self.nn, p(self.u0), p(self.u1), p(self.adj), o,
                *rest)
        return lambda: _build.check(lib.pf_stencil_step(*args), "K1")

    def k1e(self, lib):
        p = lambda t: t.data_ptr()
        Lu, part = self.energy()
        return lambda: _build.check(lib.pf_stencil_energy_step(
            self.code, 12, p(self.u0), p(self.u1), p(self.adj), p(self.out),
            p(Lu), p(part), part.numel(), *self.shape, 1, 0.25, 3.0, 0.57,
            1.14, 1.71, 0.1, 1.3, self.stream), "K1e")


_K1_LIBS: dict = {}


def _k1_libs(base: Path) -> dict:
    """Both trees' stencil.cu (with energy.cu), built once."""
    if not _K1_LIBS:
        for k, d in (("base", base), ("tree", _build.CSRC)):
            _K1_LIBS[k] = build_lib(f"k1_{k}", sources(
                d, ("stencil.cu", "energy.cu")), d)
    return _K1_LIBS


def probe_k1(base: Path):
    libs = _k1_libs(base)
    compare_sass("K1/K5 (dtype, adj, legs, tile width)", K1_SASS,
                 PROBE / "k1_base" / "stencil.o",
                 PROBE / "k1_tree" / "stencil.o")
    for shape, fcc in K1_SHAPES:
        for dt in (torch.float32, torch.float64):
            f = Fields(dt, shape, fcc)
            outs = {k: torch.empty_like(f.u0) for k in libs}
            for k, lib in libs.items():
                f.k1(lib, outs[k])()
            torch.cuda.synchronize()
            inner = (slice(1, -1),) * 3
            same = torch.equal(outs["base"][inner], outs["tree"][inner])
            del outs
            calls = {k: f.k1(lib) for k, lib in libs.items()}
            print(f"[base] K1 {dt} {'FCC' if fcc else 'Cartesian'} "
                  f"{shape}: bitwise equal {same}; "
                  + fmt(turns(calls, IN_TURNS)), flush=True)
            del calls
            probe_k1_compact(libs, f)
            del f
            torch.cuda.empty_cache()


def probe_k1_compact(libs, f):
    """The base's K1 on a box's packed grid against this tree's on its
    compact form: bit for bit, then in turns."""
    from pffdtd_tpu_torch.kernels.stencil import CompactAdj

    f.box()
    c = CompactAdj.from_grid(f.adj)
    outs = {k: torch.empty_like(f.u0) for k in libs}
    f.k1(libs["base"], outs["base"])()
    f.k1(libs["tree"], outs["tree"], compact=c)()
    torch.cuda.synchronize()
    inner = (slice(1, -1),) * 3
    same = torch.equal(outs["base"][inner], outs["tree"][inner])
    del outs
    calls = {"base": f.k1(libs["base"]), "tree": f.k1(libs["tree"],
                                                      compact=c)}
    ni = math.prod(n - 2 for n in f.shape)
    print(f"[compact] K1 {f.u0.dtype} {'FCC' if f.nn == 12 else 'Cartesian'}"
          f" {f.shape}, a box's adjacency ({c.flagged} points flagged, "
          f"{c.words} of {c.mask.numel()} words not zero, "
          f"{c.read_bytes / ni:.4f} B a point): base on the grid, tree on "
          f"the compact form, "
          f"bitwise equal {same}; " + fmt(turns(calls, IN_TURNS)),
          flush=True)


def probe_k1e(base: Path):
    libs = _k1_libs(base)
    compare_sass("K1e (dtype, adj, legs)", K1E_SASS,
                 PROBE / "k1_base" / "stencil.o",
                 PROBE / "k1_tree" / "stencil.o")
    for dt in (torch.float32, torch.float64):
        f = Fields(dt)
        Lu0 = f.energy()[0].clone()
        outs = {}
        for k, lib in libs.items():     # from the same L u^{n-1}
            f.Lu.copy_(Lu0)
            f.part.zero_()
            f.k1e(lib)()
            outs[k] = (f.out.clone(), f.Lu.clone(), f.part.clone())
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["base"],
                                                     outs["tree"]))
        del outs, Lu0
        calls = {k: f.k1e(lib) for k, lib in libs.items()}
        print(f"[base] K1e {dt} FCC {SHAPE}: u^(n+1), L u^n and sums bitwise "
              f"equal {same}; " + fmt(turns(calls, IN_TURNS)), flush=True)
        del f


def _headline_engine(dtype, open_top=False, **kw):
    from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
    from pffdtd_tpu_torch.scene import (DEF11, fold_fcc_sim, rotate_sim,
                                        sort_sim, synthetic_box_sim)

    sim = synthetic_box_sim(36.0, 28.0, 23.0, h=0.046, Nt=8, fcc=True,
                            lossy=True, insig_type="impulse", DEF=DEF11,
                            open_top=open_top)
    sim = sort_sim(fold_fcc_sim(rotate_sim(sim, orient="descending")))
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=dtype, device="cuda", **kw)


class _K2State:
    """A seeded random state for K2 on `eng`'s nodes, and K2's calls."""

    def __init__(self, eng):
        from pffdtd_tpu_torch.io.simdata import MMb

        g = torch.Generator(device="cuda").manual_seed(0)
        d = eng.data
        r = lambda *s: torch.randn(s, generator=g, device="cuda",
                                   dtype=eng.dtype)
        self.eng = eng
        self.u0, self.un = r(*d.grid.shape), r(*d.grid.shape)
        self.vh, self.gh = r(MMb, d.Nbl), r(MMb, d.Nbl)

    def call(self, lib, abc_mode=False, bufs=None):
        """K2 of `lib` on bufs (default this state's, updated in place)."""
        from pffdtd_tpu_torch.kernels.boundary import abc_lq

        e, p = self.eng, (lambda t: t.data_ptr())
        x, vh, gh = bufs or (self.un, self.vh, self.gh)
        args = [0 if e.dtype == torch.float32 else 1, p(x), p(self.u0),
                p(e.bnl), p(e.ssaf), p(e.mat), p(e.coef_table), p(e.beta),
                p(vh), p(gh), e.data.Nbl, e.data.sc.l, e.data.sc.lo2,
                p(e.abcq) if abc_mode else None, *abc_lq(e.data.sc, e.dtype)]
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: _build.check(lib.pf_boundary_update(*args, stream),
                                    "K2")


def probe_k2(base: Path):
    libs = {k: build_lib(f"k2_{k}", sources(d, ("boundary.cu",)), d)
            for k, d in (("base", base), ("tree", _build.CSRC))}
    compare_sass("K2 without the ABC mode (dtype)", K2_SASS,
                 PROBE / "k2_base" / "boundary.o",
                 PROBE / "k2_tree" / "boundary.o")
    for dtype in (np.float32, np.float64):
        s = _K2State(_headline_engine(dtype))
        outs = []
        for lib in libs.values():
            bufs = (s.un.clone(), s.vh.clone(), s.gh.clone())
            s.call(lib, bufs=bufs)()
            outs.append(bufs)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        calls = {k: s.call(lib) for k, lib in libs.items()}
        print(f"[base] K2 {np.dtype(dtype).name} headline "
              f"({s.eng.data.Nbl} nodes): bitwise equal {same}; "
              + fmt(turns(calls, IN_TURNS)), flush=True)
        del s
        torch.cuda.empty_cache()
    s = _K2State(_headline_engine(np.float32, open_top=True))
    calls = {"ABC mode": s.call(libs["tree"], abc_mode=True),
             "without": s.call(libs["tree"])}
    order = ("without", "ABC mode", "ABC mode", "without") * 2
    print(f"[abc] K2 float32, the open-top headline box "
          f"({int((s.eng.abcq > 0).sum())} of {s.eng.data.Nbl} nodes on an "
          f"ABC layer): " + fmt(turns(calls, order)), flush=True)


class _K3State:
    """A seeded random state for one K3 sweep on `eng`'s scene (a tb
    engine), and K3's calls from a library; `abc_mode` False launches the
    sweep without the ABC mode on a scene that has a Q array."""

    def __init__(self, eng):
        from pffdtd_tpu_torch.io.simdata import MMb

        g = torch.Generator(device="cuda").manual_seed(0)
        d, TB = eng.data, eng.TB
        r = lambda *s: torch.randn(s, generator=g, device="cuda",
                                   dtype=eng.dtype)
        self.eng = eng
        self.ins = (r(*d.grid.shape), r(*d.grid.shape))
        self.sts = (r(MMb, d.Nbl), r(MMb, d.Nbl))
        self.sig = r(TB, d.in_ixyz.size)

    def outputs(self):
        d, TB = self.eng.data, self.eng.TB
        z = lambda *s: torch.zeros(s, device="cuda", dtype=self.eng.dtype)
        return ([z(*d.grid.shape), z(*d.grid.shape)],
                [z(*self.sts[0].shape), z(*self.sts[0].shape)],
                z(TB - 2, d.out_ixyz.size) if TB > 2 else None)

    def call(self, lib, outs, abc_mode=True):
        from pffdtd_tpu_torch.kernels.tb import _launch_args

        st = self.eng.tb_scene
        if not abc_mode:
            st = dataclasses.replace(st, abcq=None)
        o, sts, taps = outs
        args = _launch_args(st, *self.ins, *o, *self.sts, *sts, self.sig,
                            taps)
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: _build.check(lib.pf_tb_sweep(*args, stream), "K3")


def probe_k3(base: Path):
    libs = {k: build_lib(f"k3_{k}", sources(d, ("tb.cu", "tb_shard.cu")), d)
            for k, d in (("base", base), ("tree", _build.CSRC))}
    for f, what in (("tb.o", "K3"), ("tb_shard.o", "K6")):
        compare_sass(f"{what} without the ABC mode (dtype, adj, legs, TB, "
                     f"row width, shard)", K3_SASS, PROBE / "k3_base" / f,
                     PROBE / "k3_tree" / f, each=False)
    for dtype in (np.float32, np.float64):
        s = _K3State(_headline_engine(dtype, backend="tb", tb=3))
        outs = {k: s.outputs() for k in libs}
        for k, lib in libs.items():
            s.call(lib, outs[k])()
        torch.cuda.synchronize()
        flat = lambda o: [o[0][0], o[0][1], *o[1], o[2]]
        same = all(torch.equal(a, b) for a, b in zip(flat(outs["base"]),
                                                     flat(outs["tree"])))
        calls = {k: s.call(lib, outs[k]) for k, lib in libs.items()}
        print(f"[base] K3 TB=3 {np.dtype(dtype).name} headline "
              f"({s.eng.data.Nbl} nodes, tiles {s.eng.tb_scene.lists.box}): "
              f"bitwise equal {same}; " + fmt(turns(calls, IN_TURNS)),
              flush=True)
        del s, outs, calls
        torch.cuda.empty_cache()
    s = _K3State(_headline_engine(np.float32, open_top=True, backend="tb",
                                  tb=3))
    out = s.outputs()
    calls = {"ABC mode": s.call(libs["tree"], out),
             "without": s.call(libs["tree"], out, abc_mode=False)}
    order = ("without", "ABC mode", "ABC mode", "without") * 2
    print(f"[abc] K3 TB=3 float32, the open-top headline box "
          f"({int((s.eng.abcq > 0).sum())} of {s.eng.data.Nbl} nodes on an "
          f"ABC layer): " + fmt(turns(calls, order)), flush=True)


PROBES = {"K1": probe_k1, "K1e": probe_k1e, "K2": probe_k2, "K3": probe_k3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="a directory holding another checkout's csrc "
                    "files")
    ap.add_argument("--kernels", default=",".join(PROBES),
                    help="the kernels to compare, of " + ",".join(PROBES))
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    if not set(names) <= set(PROBES):
        ap.error(f"--kernels {args.kernels}: of {','.join(PROBES)}")
    if not torch.cuda.is_available():
        raise SystemExit("the probe measures on an NVIDIA card only")
    card_line()
    for k in names:
        PROBES[k](args.base)


if __name__ == "__main__":
    sys.exit(main())
