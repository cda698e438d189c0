"""orient="auto" on the port (CPU, fp64).

`scene.rotate_sim` rotates by "auto" by default, as the JAX package's
does, on the port's own rule (`orientation_scores`: K1 and K2 on the H100,
fitted to `probes.orient`'s run; `auto_tr` keeps "descending"'s
layout unless another scores lower by more than `ORIENT_MARGIN`).  Held
here:
- `boundary_face_counts` array-equal to the JAX package's on a Cartesian,
  an FCC and a folded FCC box;
- `orientation_scores` gives inf for a folded grid's half-y axis, and
  "auto" never moves that axis off y;
- the rule's choice pinned on the grids and cut legs the probe measured
  (headline, hall, shoebox, the 10^9-voxel box: the fastest candidate on
  the step route in each), and the margin keeping "descending" where the
  scores are within it;
- with no boundary node "auto" is "descending", as in the JAX package;
- `rotate_sim(sim)` array-equal to the JAX package's `rotate_sim(sim,
  tr=<the port's choice>)`, a choice that differs from "descending";
- on such boxes, Cartesian and folded FCC, the receivers of "auto" and
  "descending" through `sort_sim(fold_fcc_sim(...))` on the step, tb and
  pair routes and on NumpyEngine within 1e-12 of max |u_out|, and "auto"
  within 1e-12 of JAX's `_step_core` route (JaxEngine(backend="xla")) on
  the same rotated scene;
- `probes.orient`'s host side: its candidates put each axis on z, its lane
  fill, and its refusal without a card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from pffdtd_tpu import demo, prep as jprep
from pffdtd_tpu.engine.jax_engine import JaxEngine

from pffdtd_tpu_torch import prep
from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.probes import orient as orient_probe
from pffdtd_tpu_torch.scene import (ORIENT_MARGIN, auto_tr,
                                    boundary_face_counts, fold_fcc_sim,
                                    orientation_scores, rotate_sim,
                                    rotation_of, sort_sim, synthetic_box_sim,
                                    tr_for)

torch.set_num_threads(2)

# (box, h, fcc, fold): boxes whose "auto" layout is not "descending"'s
BOXES = {
    "cart": ((1.6, 1.2, 0.9), 0.1, False, False),
    "fcc": ((2.2, 1.8, 1.5), 0.12, True, False),
    "fcc-folded": ((1.6, 1.2, 0.9), 0.1, True, True),
}
NT = 64
# the unrotated grids and cut legs per axis that probes.orient
# printed (NVIDIA H100 80GB HBM3, 700 W), and the candidate whose step
# route ran fastest there: (N, faces, fcc, tr)
MEASURED = {
    "headline": ((792, 618, 510), (5904952, 6252256, 6593208), 1, (1, 2, 0)),
    "hall": ((792, 618, 510), (5588780, 5891102, 6232594), 1, (1, 2, 0)),
    "shoebox": ((1074, 422, 400), (645932, 1665660, 1759380), 0, (1, 2, 0)),
    "box_1e9": ((1288, 1008, 808), (3200000, 4096000, 5120000), 0,
                (0, 2, 1)),
}


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _box(name, jax_side=False, Nt=NT):
    box, h, fcc, fold = BOXES[name]
    make, fold_fn = ((demo.synthetic_box_sim, jprep.fold_fcc_sim)
                     if jax_side else (synthetic_box_sim, fold_fcc_sim))
    sim = make(*box, h=h, Nt=Nt, fcc=fcc, lossy=True, insig_type="hann10",
               diff_source=False)
    return fold_fn(sim) if fold else sim


def _prepared(sim, orient):
    """rotate_sim by `orient`, then folded (FCC) and sorted."""
    sim = rotate_sim(sim, orient=orient)
    return sort_sim(fold_fcc_sim(sim) if sim.consts.fcc_flag == 1 else sim)


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


@pytest.mark.parametrize("name", list(BOXES))
def test_boundary_face_counts_match_jax(name):
    a = boundary_face_counts(_box(name).vox)
    b = jprep.boundary_face_counts(_box(name, jax_side=True).vox)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    assert prep.boundary_face_counts is boundary_face_counts
    assert prep.orientation_scores is orientation_scores


def test_folded_axis_scores_inf_and_stays_on_y():
    N, faces = (646, 1664, 250), (4 * 416000, 4 * 161500, 4 * 1075000)
    s = orientation_scores(N, faces, fcc=2)
    assert s[1] == np.inf and np.isfinite(s[0]) and np.isfinite(s[2])
    # "descending" would put the folded axis on x: "auto" keeps it on y
    assert tuple(np.argsort(N)[::-1])[1] != 1
    assert auto_tr(N, faces, 2)[1] == 1
    sim = _box("fcc-folded")
    assert sim.consts.fcc_flag == 2 and rotation_of(sim)[1] == 1


@pytest.mark.parametrize("scene", list(MEASURED))
def test_choice_pinned_on_the_measured_scenes(scene):
    N, faces, fcc, fastest = MEASURED[scene]
    assert auto_tr(N, faces, fcc) == fastest
    # every such choice leaves "descending" (its z axis the shortest)
    assert fastest[2] != int(np.argmin(N))


def test_margin_keeps_descending_within_it():
    N, faces, fcc, _ = MEASURED["headline"]
    # rigid: no K2 term, and K1's points differ by the fold alone
    s = orientation_scores(N, faces, fcc, lossy=False)
    assert min(s) > (1 - ORIENT_MARGIN) * s[2]
    assert auto_tr(N, faces, fcc, lossy=False) == (0, 1, 2)
    # lossy: x on z beats "descending" by more than the margin
    s = orientation_scores(N, faces, fcc)
    assert s[0] < (1 - ORIENT_MARGIN) * s[2]


def test_no_boundary_node_takes_descending():
    sim = synthetic_box_sim(1.0, 1.4, 0.8, h=0.1, Nt=4, lossy=False)
    v = sim.vox
    none = dataclasses.replace(
        sim, vox=dataclasses.replace(
            v, bn_ixyz=v.bn_ixyz[:0], adj_bn=v.adj_bn[:0],
            mat_bn=v.mat_bn[:0], saf_bn=v.saf_bn[:0]))
    assert none.vox.Nb == 0
    desc = tuple(int(t) for t in np.argsort((v.Nx, v.Ny, v.Nz))[::-1])
    assert desc != (0, 1, 2)
    assert rotation_of(none) == rotation_of(none, "descending") == desc
    j = jprep.rotate_sim(none)          # the JAX package's "auto"
    r = rotate_sim(none)
    assert (r.vox.Nx, r.vox.Ny, r.vox.Nz) == (j.vox.Nx, j.vox.Ny, j.vox.Nz)
    with pytest.raises(ValueError):
        rotate_sim(none, orient="ascending")


@pytest.mark.parametrize("name", ["cart", "fcc"])
def test_rotate_sim_matches_jax_with_the_ports_choice(name):
    sim = _box(name)
    tr = rotation_of(sim)
    assert tr != rotation_of(sim, "descending")
    a = rotate_sim(sim)
    b = jprep.rotate_sim(_box(name, jax_side=True), tr=tr)
    assert (a.vox.Nx, a.vox.Ny, a.vox.Nz) == (b.vox.Nx, b.vox.Ny, b.vox.Nz)
    for part, keys in (("vox", ("bn_ixyz", "adj_bn", "mat_bn", "saf_bn",
                                "xv", "yv", "zv")),
                       ("comms", ("in_ixyz", "out_ixyz", "in_sigs",
                                  "out_reorder", "out_alpha"))):
        for k in keys:
            x = np.asarray(getattr(getattr(a, part), k))
            y = np.asarray(getattr(getattr(b, part), k))
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@functools.lru_cache(maxsize=None)
def _descending(name):
    """The "descending" layout's receivers (the step route), in the
    receiver points' order before sorting."""
    ps = _prepared(_box(name), "descending")
    u = TorchEngine(**_kw(ps), dtype=np.float64, device="cpu").run(
        verbose=False)
    return u[ps.comms.out_reorder]


def _run(ps, route):
    if route == "numpy":
        o = NumpyEngine(**_kw(ps))
        o.run_all()
        return o.u_out
    kw = {"step": {}, "tb": {"backend": "tb", "tb": 3},
          "pair": {"backend": "pair"}}[route]
    return TorchEngine(**_kw(ps), dtype=np.float64, device="cpu",
                       **kw).run(verbose=False)


@pytest.mark.parametrize("route", ["step", "tb", "pair", "numpy"])
@pytest.mark.parametrize("name", ["cart", "fcc"])
def test_auto_receivers_match_descending(name, route):
    sim = _box(name)
    assert rotation_of(sim) != rotation_of(sim, "descending")
    ps = _prepared(sim, "auto")
    u = _run(ps, route)
    assert np.isfinite(u).all() and u.shape[1] >= NT
    assert _rel(u[ps.comms.out_reorder], _descending(name)) < 1e-12


@pytest.mark.parametrize("name", ["cart", "fcc"])
def test_auto_matches_jax_step_core_on_the_same_rotation(name):
    sim = _box(name)
    tr = rotation_of(sim)
    ps = _prepared(sim, "auto")
    js = jprep.rotate_sim(_box(name, jax_side=True), tr=tr)
    if js.consts.fcc_flag == 1:
        js = jprep.fold_fcc_sim(js)
    j = JaxEngine(**_kw(jprep.sort_sim(js)), dtype=np.float64,
                  backend="xla")
    j.run(verbose=False)
    u = _run(ps, "step")
    assert _rel(u, j.u_out) < 1e-12


def test_orient_probe_host_side():
    assert orient_probe.lane_fill(400) == pytest.approx(398 / 512)
    assert orient_probe.lane_fill(510) == pytest.approx(508 / 512)
    sim = _box("fcc")
    v = sim.vox
    N = (v.Nx, v.Ny, v.Nz)
    for k in range(3):
        ps = orient_probe.prepare(sim, tr_for(N, k, 1))
        lay = orient_probe.layout(ps)
        assert ps.consts.fcc_flag == 2 and lay["grid"][2] == N[k]
        assert lay["grid"][1] == sorted(N[j] for j in range(3)
                                        if j != k)[0] // 2 + 1
        assert 0 < lay["nbl_z"] < lay["nbl"] == int((v.mat_bn >= 0).sum())
        np.testing.assert_array_equal(lay["faces"],
                                      boundary_face_counts(ps.vox))


def test_orient_probe_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        orient_probe.main(["--scenes", "shoebox"])
    with pytest.raises(SystemExit):
        orient_probe.main(["--scenes", "nowhere"])
