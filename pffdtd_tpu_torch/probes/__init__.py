"""Measurements on the card that sit above the engine, the port's
counterparts of the repo's `probes/` scripts.

One module per probe, each run as `python -m
pffdtd_tpu_torch.probes.<name>` with a `main(argv=None)` that raises
without a card:

- `kernel_ab`: K1, K1e, K2 and K3 of this tree against another
  checkout's `csrc/` (SASS instance by instance, results bit for bit,
  times in turns);
- `orient`: each axis of a scene on z, the data behind
  `scene.orientation_scores` (the counterpart of probes/mv_orient.py).
"""
