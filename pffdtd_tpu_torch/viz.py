"""Wavefield slices, the voxelization draw, the live in-run view, animation
frames and RIR plots.

Copies of `fcc_fill_plot_holes`, `plot_wave_slices`, `plot_voxelization`,
`plot_rirs` and `LiveSliceView` from pffdtd_tpu/viz.py, and
`render_animation` driving `TorchEngine.run(on_chunk=...)` where the JAX
one drives the engine's scan.
The fields may be tensors on the card: only the three slices drawn are
copied to the host, never the whole grid.  matplotlib is imported inside
the functions (headless-safe through the Agg backend): nothing on the
engine's path needs it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pffdtd_tpu_torch.utils import ind2sub3d


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("tkagg", "qtagg", "macosx"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    """A slice as a float64 numpy array (a tensor is copied to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _slices(u, ix, iy, iz, scale=1.0):
    """The xy, xz and yz planes of u through (ix, iy, iz), on the host."""
    return [_host(u[:, :, iz]) * scale, _host(u[:, iy, :]) * scale,
            _host(u[ix, :, :]) * scale]


def fcc_fill_plot_holes(uslice, i3):
    """Fill the FCC checkerboard holes by 4-neighbour averaging."""
    u = uslice.copy()
    n1, n2 = np.meshgrid(np.arange(u.shape[0]), np.arange(u.shape[1]),
                         indexing="ij")
    hole = (n1 + n2 + i3) % 2 == 1
    avg = np.zeros_like(u)
    avg[1:-1, 1:-1] = 0.25 * (u[2:, 1:-1] + u[:-2, 1:-1]
                              + u[1:-1, 2:] + u[1:-1, :-2])
    u[hole] = avg[hole]
    return u


def plot_wave_slices(u, vox, in_ixyz=None, fcc=False, fname=None, title="",
                     scale=1.0):
    """Three orthogonal slices of a wavefield (Nx, Ny, Nz array or tensor)
    through the source point, times `scale`; the colour scale spans the
    three slices."""
    plt = _plt()
    Nx, Ny, Nz = vox.Nx, vox.Ny, vox.Nz
    if in_ixyz is not None and len(in_ixyz):
        ix, iy, iz = ind2sub3d(np.median(in_ixyz).astype(np.int64),
                               Nx, Ny, Nz)
    else:
        ix, iy, iz = Nx // 2, Ny // 2, Nz // 2
    ix, iy, iz = int(ix), int(iy), int(iz)
    sls = _slices(u, ix, iy, iz, scale)
    slices = [("xy", sls[0], (vox.xv, vox.yv), iz),
              ("xz", sls[1], (vox.xv, vox.zv), iy),
              ("yz", sls[2], (vox.yv, vox.zv), ix)]
    fig, axes = plt.subplots(1, 3, figsize=(14, 4.5))
    cmax = max(max(np.abs(s).max() for s in sls), 1e-30)
    for ax, (name, sl, (v1, v2), i3) in zip(axes, slices):
        if fcc:
            sl = fcc_fill_plot_holes(sl, int(i3))
        im = ax.imshow(sl.T, origin="lower", cmap="seismic",
                       vmin=-1.1 * cmax, vmax=1.1 * cmax,
                       extent=[v1[0], v1[-1], v2[0], v2[-1]], aspect="equal")
        ax.set_title(f"{name}-plane")
        ax.set_xlabel(name[0])
        ax.set_ylabel(name[1])
    fig.colorbar(im, ax=axes, shrink=0.8)
    fig.suptitle(title)
    if fname:
        fig.savefig(fname, dpi=110)
        plt.close(fig)
    return fig


def plot_voxelization(vs, fname=None, max_pts=200000, cut_legs=False,
                      room=None, max_legs=20000):
    """3-D voxelization debug draw (copy of pffdtd_tpu/viz.py).

    Boundary nodes scatter coloured by material (the reference's
    per-material mayavi/polyscope point clouds); cut_legs=True overlays
    the CUT adjacency legs as short green segments (the reference's
    quiver3d of ~adj_bn legs — the staircased surface normals' picture);
    room= a RoomGeo overlays its triangle wireframe.  matplotlib only;
    subsampling keeps hall-scale grids drawable."""
    plt = _plt()
    cg = vs.cg
    ix, iy, iz = ind2sub3d(vs.bn_ixyz, cg.Nx, cg.Ny, cg.Nz)
    rng = np.random.default_rng(0)
    if ix.size > max_pts:
        sel = rng.choice(ix.size, max_pts, replace=False)
        ixs, iys, izs, mat = ix[sel], iy[sel], iz[sel], vs.mat_bn[sel]
    else:
        ixs, iys, izs, mat = ix, iy, iz, vs.mat_bn
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(cg.xv[ixs], cg.yv[iys], cg.zv[izs], c=mat, s=2,
                    cmap="tab10", alpha=0.6)
    fig.colorbar(sc, ax=ax, label="material index (-1 = rigid)")
    if cut_legs and vs.adj_bn is not None:
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        segs = []
        for j in range(0, vs.vvh.shape[0], 2):    # each leg pair once
            qq = np.flatnonzero(~vs.adj_bn[:, j])
            if qq.size > max_legs // max(1, vs.vvh.shape[0] // 2):
                qq = rng.choice(
                    qq, max_legs // max(1, vs.vvh.shape[0] // 2),
                    replace=False)
            if not qq.size:
                continue
            p0 = np.c_[cg.xv[ix[qq]], cg.yv[iy[qq]], cg.zv[iz[qq]]]
            segs.append(np.stack([p0, p0 + vs.vvh[j]], axis=1))
        if segs:
            ax.add_collection3d(Line3DCollection(
                np.concatenate(segs), colors=(0, 0.8, 0, 0.5), lw=0.5))
    if room is not None:
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        tv = room.pts[room.tris]                    # (Nt, 3, 3)
        edges = np.concatenate([tv[:, (0, 1)], tv[:, (1, 2)],
                                tv[:, (2, 0)]])
        if edges.shape[0] > 3000:
            edges = edges[rng.choice(edges.shape[0], 3000, replace=False)]
        ax.add_collection3d(Line3DCollection(
            edges, colors=(0.2, 0.2, 0.2, 0.25), lw=0.4))
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if fname:
        fig.savefig(fname, dpi=110)
        plt.close(fig)
    return fig


def plot_rirs(r_out, Fs, fname=None):
    """Time traces + magnitude spectra of processed RIRs."""
    plt = _plt()
    r = np.atleast_2d(r_out)
    tv = np.arange(r.shape[-1]) / Fs
    nfft = int(2 ** np.ceil(np.log2(r.shape[-1])))
    fv = np.arange(nfft // 2 + 1) / nfft * Fs
    spec = 20 * np.log10(np.abs(np.fft.rfft(r, nfft, axis=-1)) + 1e-30)

    fig, (a1, a2) = plt.subplots(2, 1, figsize=(9, 7))
    for i in range(r.shape[0]):
        a1.plot(tv, r[i], lw=0.7, label=f"R{i + 1}")
        a2.semilogx(fv[1:], spec[i, 1:], lw=0.7, label=f"R{i + 1}")
    a1.set_xlabel("time (s)")
    a2.set_xlabel("frequency (Hz)")
    a2.set_ylabel("dB")
    a2.set_ylim(spec.max() - 80, spec.max() + 6)
    a1.legend(fontsize=7)
    if fname:
        fig.savefig(fname, dpi=110)
        plt.close(fig)
    return fig


class LiveSliceView:
    """Live in-run 3-slice wavefield view with a boundary overlay.

    Attach through `TorchEngine.run(on_chunk=view)`: the view is called
    with (step, state) after every chunk and redraws three orthogonal
    slices of state[1] = u^n through the source point.  With an interactive
    matplotlib backend the window updates in place; headless, each update
    is saved as a PNG frame in `out_dir`.  The overlay marks the boundary
    nodes in each plane: the points whose adjacency mask has a cut leg."""

    def __init__(self, engine, show: bool = True, out_dir="live_frames",
                 overlay_max=60000):
        self.plt = _plt()
        import matplotlib

        self.interactive = show and matplotlib.get_backend().lower() in (
            "tkagg", "qtagg", "macosx")
        d = engine.data
        g = d.grid
        self.fcc = d.fcc
        self.infac = d.infac
        self.out_dir = Path(out_dir)
        if not self.interactive:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        self.k = 0

        ii = np.asarray(d.in_ixyz)
        if ii.size:
            ix, iy, iz = ind2sub3d(np.int64(np.median(ii)), *g.shape)
        else:
            ix, iy, iz = g.Nx // 2, g.Ny // 2, g.Nz // 2
        self.ix, self.iy, self.iz = int(ix), int(iy), int(iz)

        full = (1 << d.NN) - 1
        rng = np.random.default_rng(0)

        def pick(plane):
            a, b = np.nonzero(plane != full)
            if a.size > overlay_max:
                idx = rng.choice(a.size, overlay_max, replace=False)
                a, b = a[idx], b[idx]
            return a, b

        adj = d.adj_grid
        self.overlays = [pick(adj[:, :, self.iz]), pick(adj[:, self.iy, :]),
                         pick(adj[self.ix, :, :])]

        self.fig, self.axes = self.plt.subplots(1, 3, figsize=(14, 4.5))
        self.ims = []
        names = ("xy", "xz", "yz")
        shapes = [(g.Nx, g.Ny), (g.Nx, g.Nz), (g.Ny, g.Nz)]
        for ax, name, shp, (oa, ob) in zip(self.axes, names, shapes,
                                           self.overlays):
            im = ax.imshow(np.zeros(shp).T, origin="lower", cmap="seismic",
                           vmin=-1.0, vmax=1.0, aspect="equal")
            ax.scatter(oa, ob, s=0.3, c="k", alpha=0.35, linewidths=0)
            ax.set_title(f"{name}-plane")
            self.ims.append(im)
        if self.interactive:
            self.fig.show()

    def __call__(self, step, state):
        sls = _slices(state[1], self.ix, self.iy, self.iz, self.infac)
        if self.fcc:
            i3 = (self.iz, self.iy, self.ix)
            sls = [fcc_fill_plot_holes(s, int(i)) for s, i in zip(sls, i3)]
        cmax = max(max(np.abs(s).max() for s in sls), 1e-30)
        for im, s in zip(self.ims, sls):
            im.set_data(s.T)
            im.set_clim(-1.1 * cmax, 1.1 * cmax)
        self.fig.suptitle(f"step {step}")
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.plt.pause(0.001)
        else:
            self.fig.savefig(self.out_dir / f"live_{self.k:04d}.png", dpi=90)
        self.k += 1


def render_animation(engine, frames=20, steps_per_frame=None,
                     out_dir="frames", fcc=False):
    """Run the engine in chunks of `steps_per_frame` steps (default
    Nt // frames), saving a slice snapshot `frame_XXXX.png` per chunk (the
    reference's run_plot loop, sim_fdtd.py:468-527, as offline frames);
    returns the files."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    d = engine.data
    spf = steps_per_frame or max(1, engine.Nt // frames)
    g = d.grid

    class _V:  # grid coordinates in points
        Nx, Ny, Nz = g.Nx, g.Ny, g.Nz
        xv, yv, zv = np.arange(g.Nx), np.arange(g.Ny), np.arange(g.Nz)

    files = []

    def frame(n, state):
        f = out_dir / f"frame_{len(files):04d}.png"
        plot_wave_slices(state[1], _V, in_ixyz=None, fcc=fcc, fname=f,
                         title=f"step {n}", scale=d.infac)
        files.append(f)

    engine.run(chunk=spf, on_chunk=frame, verbose=False)
    return files
