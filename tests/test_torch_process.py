"""The port's `process` stage and air-absorption filters vs the JAX package.

- the modal filter on the CPU (`apply_modal_filter(device="cpu")`, PyTorch
  ops) vs the JAX package's `lax.scan` (use_jax=True) and its numpy loop,
  <= 1e-12 of the largest output magnitude; the port's plain version
  (`apply_modal_filter_plain`) equal to the JAX numpy loop bit for bit;
- `air_absorption`, the visco (Stokes) and OLA filters equal to the JAX
  package's (the same numpy code);
- the port's CLI `sim --f64 --energy` then `process --fcut_lowpass 800
  --symmetric_lowpass --air_abs_filter F --save_wav --plot` for each of the
  four filters writes the files the JAX CLI writes
  (tests/test_cli_checkpoint.py:47-61), with sim_outs_processed.h5 equal to
  1e-12 and the wav files equal at their float32 precision.  The scene runs
  128 steps (25.8 ms): the visco filter refuses RIRs shorter than its start
  time, 22.9 ms at 48 kHz, 20 C and 50 % humidity.
"""

import shutil

import numpy as np
import pytest

import h5py
from scipy.io import wavfile

from pffdtd_tpu.analysis import air_abs as jair
from pffdtd_tpu.demo import synthetic_box_sim
from pffdtd_tpu.scene_setup import save_sim_data

from pffdtd_tpu_torch.analysis import air_abs


def _burst(Fs, T, nch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(T * Fs)) / Fs
    return rng.standard_normal((nch, t.size)) * np.exp(-t / 0.05)


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


@pytest.mark.parametrize("Fs, T, nch, pad_t", [(8000.0, 0.05, 1, 0.0),
                                               (48000.0, 0.1, 2, 0.01)])
def test_modal_filter_matches_jax(Fs, T, nch, pad_t):
    x = _burst(Fs, T, nch, seed=int(Fs) + nch)
    kw = dict(Tc=20.0, rh=50.0, pad_t=pad_t)
    y = air_abs.apply_modal_filter(x, Fs, device="cpu", **kw)
    yj = jair.apply_modal_filter(x, Fs, use_jax=True, **kw)
    yn = jair.apply_modal_filter(x, Fs, use_jax=False, **kw)
    assert y.shape == yj.shape == yn.shape
    assert _rel(y, yj) < 1e-12
    assert _rel(y, yn) < 1e-12
    assert np.array_equal(air_abs.apply_modal_filter_plain(x, Fs, **kw), yn)


def test_air_absorption_and_filters_equal_the_originals():
    f = np.geomspace(10.0, 24000.0, 50)
    a, b = air_abs.air_absorption(f, 25.0, 40.0), jair.air_absorption(
        f, 25.0, 40.0)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    x = _burst(48000.0, 0.05, 2, seed=3)
    for name in ("apply_visco_filter", "apply_ola_filter"):
        np.testing.assert_array_equal(
            getattr(air_abs, name)(x, 48000.0, 20.0, 50.0),
            getattr(jair, name)(x, 48000.0, 20.0, 50.0), err_msg=name)
    # a signal shorter than the visco filter's start time (22.9 ms at
    # 48 kHz): the JAX package fails to broadcast, the port says why
    with pytest.raises(ValueError, match="start time"):
        air_abs.apply_visco_filter(x[:, :400], 48000.0, 20.0, 50.0)


@pytest.fixture(scope="module")
def sim_dirs(tmp_path_factory):
    """One sim folder run through each CLI's `sim --f64 --energy`."""
    from pffdtd_tpu.cli import main as jax_main
    from pffdtd_tpu_torch.cli import main as torch_main

    base = tmp_path_factory.mktemp("sims")
    a, b = base / "jax", base / "torch"
    # 128 steps, 25.8 ms: the visco filter needs more than its start time
    sim = synthetic_box_sim(2.2, 1.8, 1.5, h=0.12, Nt=128, lossy=True,
                            insig_type="hann10", diff_source=False)
    save_sim_data(sim, a)
    shutil.copytree(a, b)
    jax_main(["sim", "--data_dir", str(a), "--f64", "--energy"])
    torch_main(["sim", "--data_dir", str(b), "--f64", "--energy",
                "--device", "cpu"])
    return a, b


def _read(path, key):
    with h5py.File(path, "r") as f:
        return f[key][...]


@pytest.mark.parametrize("filt", ["none", "stokes", "modal", "ola"])
def test_cli_process_matches_jax_cli(filt, sim_dirs, tmp_path):
    from pffdtd_tpu.cli import main as jax_main
    from pffdtd_tpu_torch.cli import main as torch_main

    a, b = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(sim_dirs[0], a)
    shutil.copytree(sim_dirs[1], b)
    assert _rel(_read(b / "sim_outs.h5", "u_out"),
                _read(a / "sim_outs.h5", "u_out")) < 1e-12
    argv = ["process", "--fcut_lowpass", "800", "--symmetric_lowpass",
            "--air_abs_filter", filt, "--save_wav", "--plot"]
    jax_main(argv + ["--data_dir", str(a)])
    torch_main(argv + ["--data_dir", str(b), "--device", "cpu"])

    names = lambda d: sorted(p.name for p in d.iterdir())
    assert names(a) == names(b)
    assert (b / "R001_out_normalised.wav").exists()
    assert (b / "rirs.png").stat().st_size > 1000
    pa, pb = a / "sim_outs_processed.h5", b / "sim_outs_processed.h5"
    assert _read(pa, "Fs_f") == _read(pb, "Fs_f")
    ra, rb = _read(pa, "r_out_f"), _read(pb, "r_out_f")
    assert ra.shape == rb.shape
    assert _rel(rb, ra) < 1e-12
    assert _rel(_read(b / "sim_outs.h5", "r_out"),
                _read(a / "sim_outs.h5", "r_out")) < 1e-12
    for w in sorted(a.glob("*.wav")):
        ra_, wa = wavfile.read(w)
        rb_, wb = wavfile.read(b / w.name)
        assert ra_ == rb_ and wa.shape == wb.shape
        assert np.abs(wb - wa).max() <= 1e-6 * np.abs(wa).max()
