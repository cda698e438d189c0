"""The port's sharded fp32 routes vs the JAX sharded Pallas engines in
interpret mode on the conftest's CPU mesh, with the JAX tests' own bars.

- `step` at D = 4 vs `ShardedPallasEngine(interpret=True)` (the fused
  stencil kernel per shard, `build_fused_stencil_sharded`, with the
  windowed boundary kernels): <= 2e-5 of max |u_out|, the bar of
  tests/test_sharded_pallas.py:49;
- `pair` at D = 4 vs `ShardedPairEngine(interpret=True)` (the pair kernel
  in shard mode, `build_fused_pair(shard=)`) on the lossy folded-FCC scene
  of tests/test_sharded_pair.py:79-89 (z/y impedance planes, x walls
  rigid): <= 1e-4, its bar.
Both packages get the same scene, built by the port's functions.
"""

import numpy as np
import torch

from pffdtd_tpu.parallel.sharded_engine import make_mesh
from pffdtd_tpu.parallel.sharded_pallas import (ShardedPairEngine,
                                                ShardedPallasEngine)

from test_sharded_pair import _rigidify_x_walls
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import (fold_fcc_sim, pad_x_interior, rotate_sim,
                                    sort_sim, synthetic_box_sim)

torch.set_num_threads(2)
D = 4


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _rel(u, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(u - ref).max() / scale


def test_step_route_matches_sharded_pallas_engine():
    sim = pad_x_interior(synthetic_box_sim(
        3.1, 2.0, 1.7, h=0.12, Nt=40, lossy=True, insig_type="hann10",
        diff_source=False), D)
    jx = ShardedPallasEngine(**_kw(sim), mesh=make_mesh(D),
                             dtype=np.float32, interpret=True)
    u_j = jx.run(verbose=False)
    eng = make_sharded_engine(**_kw(sim), devices=["cpu"] * D,
                              dtype=np.float32, backend="step")
    assert eng.S == jx.S
    assert _rel(eng.run(verbose=False), u_j) < 2e-5


def test_pair_route_matches_sharded_pair_engine(monkeypatch):
    monkeypatch.setenv("PFFDTD_ZPLANE_MIN_COUNT", "1")
    monkeypatch.setenv("PFFDTD_ZPLANE_MIN_DENSITY", "0.12")
    sim = synthetic_box_sim(2.2, 1.8, 1.5, h=0.12, Nt=30, lossy=True,
                            fcc=True, insig_type="hann10",
                            diff_source=False)
    sim = sort_sim(fold_fcc_sim(rotate_sim(sim)))
    sim = _rigidify_x_walls(pad_x_interior(sim, D))
    jx = ShardedPairEngine(**_kw(sim), mesh=make_mesh(D), dtype=np.float32,
                           interpret=True)
    u_j = jx.run(verbose=False)
    eng = make_sharded_engine(**_kw(sim), devices=["cpu"] * D,
                              dtype=np.float32, backend="pair")
    assert eng.TB == 2 and eng.S == jx.S and eng.grafts
    u = eng.run(verbose=False)
    assert _rel(u, u_j[:, :u.shape[1]]) < 1e-4
