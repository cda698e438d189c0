"""Air absorption: the ISO 9613-1 model and three RIR filtering methods.

Copy of pffdtd_tpu/analysis/air_abs.py (numpy/scipy), except that the modal
filter's per-sample recurrence runs on a device (the card by default, as
the hand-written kernel K8) where the JAX package runs it as a `lax.scan`.
Physics parity targets:
- `air_absorption`: ISO 9613-1 atmospheric attenuation — relaxation
  frequencies frO/frN, classical + vibrational Np/m and dB/m curves, and the
  modified viscothermal coefficients used by the filters
  (reference: python/air_abs/get_air_absorption.py:20-127).
- `apply_visco_filter`: time-varying Gaussian smearing from the approximate
  Green's function of Stokes' equation [Hamilton, DAFx2021]
  (visco_filter.py:31-67) — here fully vectorised over output samples
  (the reference loops sample-by-sample with numba).
- `apply_modal_filter`: DCT-domain bank of damped 1-D wave equations tuned
  to the attenuation curve [Hamilton, I3DA 2021] (modal_filter.py:34-86) —
  here the per-sample recurrence runs over all modes at once in float64,
  on the card as one launch of K8 (`modal_recurrence`, csrc/modal.cu: the
  loop on the modes at both ends of the spectrum, a contraction with each
  mode's impulse response on the rest), beside its plain numpy loop
  (`modal_recurrence_plain`; the reference uses a numba loop).
- `apply_ola_filter`: STFT overlap-add with distance-dependent e^{-alpha d}
  gains, 1024-tap Hann at 75% overlap (ola_filter.py:33-79) — here all
  frames are built and FFT'd as one batch.
"""

from __future__ import annotations

import numpy as np
from numpy import cos, exp, log, log10, pi, sqrt

from pffdtd_tpu_torch.utils import iceil, iround


def air_absorption(freq_vec, Tc, rh, pressure_kPa=101.325):
    """ISO 9613-1 attenuation curves and derived constants (dict)."""
    assert pressure_kPa <= 200
    assert -20 <= Tc <= 50
    assert 10 <= rh <= 100

    f = np.asarray(freq_vec, np.float64)
    f2 = f * f
    pi2 = pi * pi
    Tk = Tc + 273.15
    T01 = 273.16    # triple point
    T0 = 293.15     # standard temperature
    pa = pr = 101.325

    thO, thN = 2239.1, 3352.0       # vibrational temperatures
    XO, XN = 0.209, 0.781           # molar fractions
    const = 2 * pi / 35 * (10 * log10(exp(2)))

    almO = const * XO * (thO / Tk) ** 2 * exp(-thO / Tk)
    almN = const * XN * (thN / Tk) ** 2 * exp(-thN / Tk)

    p = pa / pr
    Tr = Tk / T0
    c = 343.2 * sqrt(Tr)

    C = -6.8346 * (T01 / Tk) ** 1.261 + 4.6151
    h = rh * (10 ** C) * p

    frO = p * (24 + 4.04e4 * h * (0.02 + h) / (0.391 + h))
    frN = p * Tr ** (-0.5) * (9 + 280 * h * exp(-4.17 * (Tr ** (-1 / 3) - 1)))

    absClRo = 1.6e-10 * sqrt(Tr) * f2 / p
    eta = log(10) * 1.6e-11 / (4 * pi2) * c * c * sqrt(Tr) / p
    absVibO = almO * (f / c) * (2 * (f / frO) / (1 + (f / frO) ** 2))
    absVibN = almN * (f / c) * (2 * (f / frN) / (1 + (f / frN) ** 2))
    absfull = absClRo + absVibO + absVibN
    etaO = almO * (c / pi2 / frO) * log(10) / 20

    np_fac = log(10) / 20
    return {
        "gamma_p": etaO / c, "gamma": eta / c, "etaO": etaO, "eta": eta,
        "almN": almN, "almO": almO, "c": c, "frO": frO, "frN": frN,
        "absVibN_dB": absVibN, "absVibO_dB": absVibO, "absClRo_dB": absClRo,
        "absfull_dB": absfull, "absVibN_Np": absVibN * np_fac,
        "absVibO_Np": absVibO * np_fac, "absClRo_Np": absClRo * np_fac,
        "absfull_Np": absfull * np_fac,
    }


def apply_visco_filter(x, Fs, Tc, rh, NdB=120, t_start=None):
    """Stokes'-equation Gaussian-kernel air absorption (DAFx2021).

    x: (Nch, Nt) or (Nt,).  Returns the filtered (possibly lengthened) array.
    """
    rd = air_absorption(1.0, Tc, rh)
    g = rd["gamma_p"]
    Ts = 1.0 / Fs
    if t_start is None:
        t_start = Ts ** 2 / (2 * pi * g)

    x = np.atleast_2d(np.asarray(x, np.float64))
    Nt0 = x.shape[-1]
    dt_end = Fs * sqrt(0.1 * log(10) * NdB * (Nt0 - 1) * Ts * g)
    Nt = Nt0 + iceil(dt_end)

    y = np.zeros((x.shape[0], Nt))
    n_start = iceil(t_start * Fs)
    assert n_start > 0
    if n_start > Nt0:   # the JAX package fails here with a broadcast error
        raise ValueError(f"visco filter: {Nt0} samples, shorter than its "
                         f"start time t_start = {t_start:.3e} s "
                         f"({n_start} samples)")
    y[:, :n_start] = x[:, :n_start]

    Tsg2 = 2 * Ts * g
    Tsg2pi = Tsg2 * pi
    dt_fac = 0.1 * log(10) * NdB * g * Ts

    # vectorised: for each input sample n, spread a Gaussian of half-width
    # dt(n) around output sample n; batch over bands of equal dt_int
    n_all = np.arange(n_start, Nt0)
    dt = np.sqrt(dt_fac * n_all) / Ts
    dt_int = np.ceil(dt).astype(np.int64)
    for w in np.unique(dt_int):
        sel = n_all[dt_int == w]
        offs = np.arange(-w, w + 1)
        idx = sel[:, None] + offs[None, :]
        gain = (Ts / np.sqrt(sel * Tsg2pi))[:, None] * np.exp(
            -(offs[None, :] * Ts) ** 2 / (sel[:, None] * Tsg2))
        contrib = x[:, sel, None] * gain[None, :, :]
        np.add.at(y, (slice(None), idx), contrib)
    return np.squeeze(y)


def _modal_setup(x, Fs, Tc, rh, pad_t):
    """The modal bank of `apply_modal_filter`: the recurrence coefficients
    a1, a2, Fmsig1, Fmsig2 (Nch, Nt) and the time-reversed input u
    (Nch, Nt + 1), all float64."""
    from scipy.fft import dct

    Ts = 1.0 / Fs
    x = np.atleast_2d(np.asarray(x, np.float64))
    Nt0 = x.shape[-1]
    Nt = iceil(pad_t / Ts) + Nt0
    xp = np.zeros((x.shape[0], Nt))
    xp[:, :Nt0] = x

    wqTs = pi * (np.arange(Nt) / Nt)
    wq = wqTs / Ts
    rd = air_absorption(wq / 2 / pi, Tc, rh)
    alphaq = rd["absfull_Np"]
    c = rd["c"]

    fx = np.zeros((x.shape[0], Nt))
    fx[:, 0] = 1
    Fm = dct(fx, type=2, norm="ortho", axis=-1)

    sigqTs = c * alphaq * Ts
    a1 = 2 * exp(-sigqTs) * cos(wqTs)
    a2 = -exp(-2 * sigqTs)
    Fmsig1 = Fm * (1 + sigqTs / 2) / (1 + sigqTs)
    Fmsig2 = Fm * (1 - sigqTs / 2) / (1 + sigqTs)

    u = np.zeros((x.shape[0], Nt + 1))
    u[:, 1:] = xp[:, ::-1]  # soft source feeds the time-reversed signal
    return a1, a2, Fmsig1, Fmsig2, u


def modal_recurrence(a1, a2, Fmsig1, Fmsig2, u, device="cuda"):
    """The per-sample recurrence of every mode on `device` in float64;
    returns the final P (Nch, Nt) as numpy (a1, a2: (Nt,)).

        P_new = a1 P_curr + a2 P_prev + Fmsig1 u[n+1] - Fmsig2 u[n]

    On the card one K8 launch (`kernels.modal.modal_scan`, csrc/modal.cu)
    runs every sample; on the CPU its plain version, PyTorch ops a sample
    (`modal_scan_plain`).  The carry is (P_prev, P_curr), as the JAX scan's,
    so the reference's swap subtlety (its loop swaps every step except after
    the last) comes out right: the result is P_curr.  On the CPU each
    product and sum is its own correctly rounded op, in the numpy loop's
    order, so the result equals `modal_recurrence_plain`'s bit for bit.  On
    the card K8 gives those bits on the modes q < q0 and q >= Nt - q0
    (`kernels.modal.serial_modes`) and reorders the sums on the others,
    within 1e-12 of max|P|."""
    import torch

    from pffdtd_tpu_torch.kernels.modal import modal_scan

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: torch.cuda.is_available() is "
                           "False; pass device='cpu'")
    t = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float64)).to(dev)
    F1 = t(Fmsig1)
    out = torch.empty_like(F1)
    modal_scan(t(a1), t(a2), F1, t(Fmsig2), t(u), out)
    return out.cpu().numpy()


def modal_recurrence_plain(a1, a2, Fmsig1, Fmsig2, u):
    """The numpy loop of the JAX package's `use_jax=False` branch; over
    every sample of u (Nch, Nt + 1) on the modes given (any number)."""
    P_prev = np.zeros_like(Fmsig1)
    P_curr = np.zeros_like(Fmsig1)
    for n in range(u.shape[-1] - 1):
        P_new = (a1 * P_curr + a2 * P_prev
                 + Fmsig1 * u[:, n + 1][:, None]
                 - Fmsig2 * u[:, n][:, None])
        P_prev, P_curr = P_curr, P_new
    return P_curr


def apply_modal_filter(x, Fs, Tc, rh, pad_t=0.0, device="cuda"):
    """Modal air absorption (I3DA 2021): bank of damped 1-D wave equations.

    The DCT and IDCT run on the host with scipy, as in the JAX package, the
    recurrence on `device` (`modal_recurrence`)."""
    from scipy.fft import idct

    P0 = modal_recurrence(*_modal_setup(x, Fs, Tc, rh, pad_t), device=device)
    return np.squeeze(idct(P0, type=2, norm="ortho", axis=-1))


def apply_modal_filter_plain(x, Fs, Tc, rh, pad_t=0.0):
    """`apply_modal_filter` with the numpy loop: its plain version."""
    from scipy.fft import idct

    P0 = modal_recurrence_plain(*_modal_setup(x, Fs, Tc, rh, pad_t))
    return np.squeeze(idct(P0, type=2, norm="ortho", axis=-1))


def apply_ola_filter(x, Fs, Tc, rh, Nw=1024):
    """STFT overlap-add air absorption with distance-dependent gains."""
    from scipy.fft import irfft, rfft

    Ts = 1.0 / Fs
    x = np.atleast_2d(np.asarray(x, np.float64))
    Nt0 = x.shape[-1]

    OLF = 0.75
    Ha = iround(Nw * (1 - OLF))
    Nfft = int(2 ** np.ceil(np.log2(Nw)))
    NF = iceil((Nt0 + Nw) / Ha)
    Np = (NF - 1) * Ha - Nt0
    assert Nw - Ha <= Np < Nw
    Nfft_h = Nfft // 2 + 1

    xp = np.zeros((x.shape[0], Nw + Nt0 + Np))
    xp[:, Nw:Nw + Nt0] = x

    wa = 0.5 * (1 - cos(2 * pi * np.arange(Nw) / Nw))
    ws = wa / (3 / 8 * Nw / Ha)

    fv = np.arange(Nfft_h) / Nfft * Fs
    rd = air_absorption(fv, Tc, rh)
    c = rd["c"]
    absNp = rd["absfull_Np"]

    # all frames at once: strided frame matrix + batched FFTs
    na0 = np.arange(NF) * Ha
    frames = np.stack([xp[:, s:s + Nw] for s in na0], axis=1)  # (Nch,NF,Nw)
    dist = c * Ts * (na0 - Nw / 2)
    gain = np.exp(-absNp[None, :] * np.maximum(dist, 0.0)[:, None])
    F = rfft(frames * wa, Nfft, axis=-1) * gain[None, :, :]
    yf = irfft(F, Nfft, axis=-1)[..., :Nw] * ws
    # frames with negative distance pass through unfiltered (pre-padding)
    neg = dist < 0
    yf[:, neg, :] = frames[:, neg, :] * ws

    yp = np.zeros_like(xp)
    for m, s in enumerate(na0):  # overlap-add (frame count is small)
        yp[:, s:s + Nw] += yf[:, m]
    return np.squeeze(yp[:, Nw:])
