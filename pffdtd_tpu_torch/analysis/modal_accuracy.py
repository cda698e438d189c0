"""How far K8's mode split may reorder the modal filter's sums, on the CPU.

    python -m pffdtd_tpu_torch.analysis.modal_accuracy [Nt ...]

For each length Nt (default 960 .. 96,000), at 8 and 48 kHz, 20 C and 50 %
humidity, for white noise and for a decaying signal (e^{-t / 50 ms}), two
channels from a seed, prints relative to max|P| of the numpy loop
(`modal_recurrence_plain`):

- `need`: the fewest modes (low end, high end) that must keep the loop for
  the contraction (`kernels.modal._contract`, float64) to lie within 5e-13
  of the loop on every other mode: half of the 1e-12 bar, the margin;
- `q0`: `kernels.modal.serial_modes(Nt)`, and `err`: the contraction's
  largest distance from the loop over the modes q0 <= q < Nt - q0, which
  must stay under 5e-13;
- at 4,800, 12,000 and 48,000 samples (48 kHz, white noise), `loop_ld` and
  `contr_ld`: the loop's and the contraction's float64 distance from the
  loop in np.longdouble, the value the two approximate.

Beyond 12,000 samples the modes compared are a subset: the lowest and the
highest 2 q0 and every 97th.  The whole default run takes some minutes on
one core.
"""

from __future__ import annotations

import sys

import numpy as np

from pffdtd_tpu_torch.analysis.air_abs import (_modal_setup,
                                               modal_recurrence_plain)
from pffdtd_tpu_torch.kernels.modal import _contract, serial_modes

BAR = 5e-13
LENGTHS = (960, 2052, 4800, 12000, 24000, 48000, 96000)
LD_LENGTHS = (4800, 12000, 48000)


def need(q, d, nt):
    """Fewest (low, high) end modes to keep off the contraction so that
    d <= BAR on every other mode of q."""
    bad, lo = d > BAR, q < nt // 2
    low = int(q[bad & lo].max()) + 1 if (bad & lo).any() else 0
    high = nt - int(q[bad & ~lo].min()) if (bad & ~lo).any() else 0
    return low, high


def case(nt, Fs, decay, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, nt))
    if decay:
        x *= np.exp(-np.arange(nt) / (0.05 * Fs))
    a1, a2, F1, F2, u = _modal_setup(x, Fs, 20.0, 50.0, 0.0)
    q0 = serial_modes(nt)
    q = np.arange(nt) if nt <= 12000 else np.unique(np.r_[
        np.arange(2 * q0), np.arange(nt - 2 * q0, nt), np.arange(0, nt, 97)])
    sub = (a1[q], a2[q], F1[:, q], F2[:, q], u)
    P = modal_recurrence_plain(*sub)
    C = _contract(*sub)
    scale = np.abs(P).max()
    d = np.abs(C - P).max(0) / scale
    mid = (q >= q0) & (q < nt - q0)
    line = (f"Nt {nt} Fs {Fs:.0f} {'decay' if decay else 'noise'}: need "
            f"{need(q, d, nt)}, q0 {q0}, err "
            f"{d[mid].max() if mid.any() else 0.0:.3e}")
    if nt in LD_LENGTHS and Fs == 48000.0 and not decay:
        L = modal_recurrence_plain(*(np.asarray(a, np.longdouble)
                                     for a in sub))
        line += (f", loop_ld {float(np.abs(P - L).max() / scale):.3e}, "
                 f"contr_ld {float(np.abs(C - L).max() / scale):.3e}")
    return line


def main(argv):
    for nt in map(int, argv or LENGTHS):
        for Fs in (8000.0, 48000.0):
            for decay in (False, True):
                print(case(nt, Fs, decay), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
