"""The port's benchmark: one-card cells of room simulations on
`pffdtd_tpu_torch`, run by `python -m rirbench.run` (see run.py)."""
