"""Hand-written CUDA kernels, each beside its plain PyTorch version: K1
`stencil.stencil_step`, K2 `boundary.boundary_update`, K3 `tb.tb_sweep`, K4
`stream.stream`, the x-slab shard modes K5 `stencil.stencil_step_shard` and
K6 `tb.tb_sweep_shard`, the energy terms K7 (`energy`) with K1's energy
mode K1e `stencil.stencil_energy_step`, and the modal recurrence K8
`modal.modal_scan`.

Importing this package builds nothing: the CUDA library is compiled on the
first launch on a CUDA tensor (`_build.library`)."""
