"""RIR post-processing: recombine, integrate/low-cut, resample, low-pass,
air absorption, save.

Copy of pffdtd_tpu/analysis/process_outputs.py.  It reads the sim folder
through the port's `io.h5` and filters with the port's `analysis.air_abs`,
whose modal filter runs its recurrence on a device (`--device`, the card by
default).  h5py and scipy are imported inside the functions: the stage runs
where h5py is installed.

Pipeline parity target (reference: python/fdtd/process_outputs.py:33-358):
- recombine raw grid outputs with the 8-point trilinear receiver weights
  (r_out = sum alpha * u_out, :86-103);
- when the source was differentiated (the fp32 safeguard), apply a combined
  integrator + Butterworth high-pass designed in the analog domain with one
  zero removed, bilinear-transformed (:106-127);
- optional symmetric (forward-backward) low-pass at fmax (:134-151);
- resample to 48 kHz (:153-166) — scipy polyphase here (resampy in the
  reference; equivalent quality, not bit-identical);
- one of three air-absorption filters (:168-205);
- save .wav (native + normalised) and sim_outs_processed.h5 (:274-297).
"""

from __future__ import annotations

from fractions import Fraction
from pathlib import Path

import numpy as np
from numpy import pi

from pffdtd_tpu_torch.io.h5 import read_comms, read_consts, read_outputs
from pffdtd_tpu_torch.utils import wavwrite


class ProcessOutputs:
    def __init__(self, data_dir):
        self.data_dir = Path(data_dir)
        comms = read_comms(self.data_dir)
        self.out_alpha = comms.out_alpha
        self.Nt, self.Nr, self.diff = comms.Nt, comms.Nr, comms.diff
        consts = read_consts(self.data_dir)
        self.Ts, self.Tc, self.rh = consts.Ts, consts.Tc, consts.rh
        self.u_out = read_outputs(self.data_dir)
        if self.u_out.size != self.Nr * self.Nt:
            raise ValueError(f"sim_outs.h5 holds {self.u_out.shape}, the "
                             f"sim folder {self.Nr} outputs x {self.Nt} "
                             f"steps")
        self.Fs = 1.0 / self.Ts
        self.Fs_f = self.Fs
        self.r_out = None
        self.r_out_f = None

    # ------------------------------------------------------------- pipeline
    def initial_process(self, fcut=10.0, N_order=4):
        """Recombine receiver weights; integrate (if diff'd) + low-cut."""
        from scipy.signal import bilinear_zpk, butter, lfilter, sosfilt, \
            zpk2sos

        u = self.u_out.reshape(*self.out_alpha.shape, -1)
        r_out = np.sum(u * self.out_alpha[..., None], axis=1)
        self.r_out = r_out

        if fcut > 0:
            if self.diff:
                # analog high-pass with one zero removed = combined
                # integrator + low-cut after the bilinear transform
                z, p, k = butter(N_order, fcut * 2 * pi, btype="high",
                                 analog=True, output="zpk")
                assert np.all(z == 0.0)
                z = z[1:]
                zd, pd, kd = bilinear_zpk(z, p, k, 1 / self.Ts)
                sos = zpk2sos(zd, pd, kd)
            else:
                sos = butter(N_order, 2 * self.Ts * fcut, btype="high",
                             output="sos")
            r_out_f = sosfilt(sos, r_out)
        elif self.diff:
            b = self.Ts / 2 * np.array([1.0, 1.0])
            a = np.array([1.0, 1.0])
            r_out_f = lfilter(b, a, r_out)
        else:
            r_out_f = r_out.copy()
        self.r_out_f = np.atleast_2d(r_out_f)

    def resample(self, Fs_f=48e3):
        from scipy.signal import resample_poly

        if self.Fs_f == Fs_f:
            return
        frac = Fraction(Fs_f / self.Fs_f).limit_denominator(10000)
        self.r_out_f = resample_poly(self.r_out_f, frac.numerator,
                                     frac.denominator, axis=-1)
        self.Fs_f = Fs_f

    def apply_lowpass(self, fcut, N_order=8, symmetric=True):
        from scipy.signal import butter, sosfilt

        if symmetric:
            assert N_order % 2 == 0
            N_order //= 2
        sos = butter(N_order, 2 * fcut / self.Fs_f, btype="low", output="sos")
        r = sosfilt(sos, self.r_out_f)
        if symmetric:  # second pass time-reversed removes the phase shift
            r = sosfilt(sos, r[:, ::-1])[:, ::-1]
        self.r_out_f = r

    def apply_stokes_filter(self, NdB=120):
        from pffdtd_tpu_torch.analysis.air_abs import apply_visco_filter

        self.r_out_f = np.atleast_2d(apply_visco_filter(
            self.r_out_f, self.Fs_f, Tc=self.Tc, rh=self.rh, NdB=NdB))

    def apply_modal_filter(self, device="cuda"):
        from pffdtd_tpu_torch.analysis.air_abs import apply_modal_filter

        self.r_out_f = np.atleast_2d(apply_modal_filter(
            self.r_out_f, self.Fs_f, Tc=self.Tc, rh=self.rh, device=device))

    def apply_ola_filter(self):
        from pffdtd_tpu_torch.analysis.air_abs import apply_ola_filter

        self.r_out_f = np.atleast_2d(apply_ola_filter(
            self.r_out_f, self.Fs_f, Tc=self.Tc, rh=self.rh))

    # ----------------------------------------------------------------- save
    def save_h5(self):
        import h5py

        with h5py.File(self.data_dir / "sim_outs_processed.h5", "w") as f:
            f.create_dataset("r_out_f", data=self.r_out_f)
            f.create_dataset("Fs_f", data=self.Fs_f)
        # also append r_out at the native rate (reference behaviour)
        with h5py.File(self.data_dir / "sim_outs.h5", "r+") as f:
            if "r_out" in f:
                del f["r_out"]
            f.create_dataset("r_out", data=self.r_out)

    def save_wav(self):
        r = np.atleast_2d(self.r_out_f)
        n_fac = np.abs(r).max()
        for i in range(r.shape[0]):
            wavwrite(self.data_dir / f"R{i + 1:03d}_out_normalised.wav",
                     int(self.Fs_f), r[i] / n_fac)
            if n_fac < 1.0:
                wavwrite(self.data_dir / f"R{i + 1:03d}_out_native.wav",
                         int(self.Fs_f), r[i])


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="process sim_outs.h5 into RIRs")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--resample_Fs", type=float, default=48e3)
    p.add_argument("--fcut_lowcut", type=float, default=10.0)
    p.add_argument("--N_order_lowcut", type=int, default=8)
    p.add_argument("--fcut_lowpass", type=float, default=0.0)
    p.add_argument("--N_order_lowpass", type=int, default=8)
    p.add_argument("--symmetric_lowpass", action="store_true")
    p.add_argument("--air_abs_filter", default="none",
                   choices=["none", "stokes", "modal", "ola"])
    p.add_argument("--save_wav", action="store_true")
    p.add_argument("--plot", action="store_true",
                   help="plot time traces + spectra per receiver "
                        "(reference parity: process_outputs.py:207-269); "
                        "saves rirs.png into the sim folder")
    p.add_argument("--show", action="store_true",
                   help="with --plot, open a window instead of saving")
    p.add_argument("--device", default="cuda",
                   help="torch device of the modal filter's recurrence: "
                        "cuda (the default) or cpu")
    args = p.parse_args(argv)

    po = ProcessOutputs(Path(args.data_dir))
    po.initial_process(fcut=args.fcut_lowcut, N_order=args.N_order_lowcut)
    if args.resample_Fs:
        po.resample(args.resample_Fs)
    if args.fcut_lowpass > 0:
        po.apply_lowpass(fcut=args.fcut_lowpass, N_order=args.N_order_lowpass,
                         symmetric=args.symmetric_lowpass)
    if args.air_abs_filter == "modal":
        po.apply_modal_filter(device=args.device)
    elif args.air_abs_filter == "stokes":
        po.apply_stokes_filter()
    elif args.air_abs_filter == "ola":
        po.apply_ola_filter()
    po.save_h5()
    if args.save_wav:
        po.save_wav()
    if args.plot:
        from pffdtd_tpu_torch.viz import plot_rirs

        fname = None if args.show else Path(args.data_dir) / "rirs.png"
        plot_rirs(po.r_out_f, po.Fs_f, fname=fname)
        if fname:
            print(f"--PROCESS: wrote {fname}")


if __name__ == "__main__":
    main()
