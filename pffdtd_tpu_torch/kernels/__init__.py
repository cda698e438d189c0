"""Hand-written CUDA kernels, each beside its plain PyTorch version: K1
`stencil.stencil_step`, K2 `boundary.boundary_update`, K3 `tb.tb_sweep`, K4
`stream.stream`, the x-slab shard modes K5 `stencil.stencil_step_shard` and
K6 `tb.tb_sweep_shard`, the energy terms K7 (`energy`) with K1's energy
mode K1e `stencil.stencil_energy_step`, and the modal recurrence K8
`modal.modal_scan`; and the build, `_build`.  Tools that use them (the
A/B and orientation probes) live above the engine, in
`pffdtd_tpu_torch.probes`.

Importing this package builds nothing: the CUDA library is compiled on the
first launch on a CUDA tensor (`_build.library`)."""


def __getattr__(name):
    """`WRAPPERS`: the kernels' wrappers by name, each of which adds one to
    its `launches` where it launches its kernel; the one table that the
    bench, `examples.setup_1e9` and chip_smoke.py count with.  K7 is its
    boundary pass: K1e computes its grid half.  Built on first use: the
    wrappers' modules import the engine's, which import this package."""
    if name != "WRAPPERS":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from pffdtd_tpu_torch.kernels.boundary import boundary_update
    from pffdtd_tpu_torch.kernels.energy import energy_boundary_pass
    from pffdtd_tpu_torch.kernels.modal import modal_scan
    from pffdtd_tpu_torch.kernels.stencil import (stencil_energy_step,
                                                  stencil_step,
                                                  stencil_step_shard)
    from pffdtd_tpu_torch.kernels.stream import stream
    from pffdtd_tpu_torch.kernels.tb import tb_sweep, tb_sweep_shard
    table = {"K1": stencil_step, "K2": boundary_update, "K3": tb_sweep,
             "K4": stream, "K5": stencil_step_shard, "K6": tb_sweep_shard,
             "K7": energy_boundary_pass, "K8": modal_scan,
             "K1e": stencil_energy_step}
    globals()["WRAPPERS"] = table
    return table
