"""K8's design, the mode split, on the CPU through its plain version.

`kernels.modal.modal_split_plain` runs the loop (`modal_scan_plain`'s ops)
on the modes q < q0 and q >= Nt - q0, q0 = `serial_modes(Nt)`, and the
contraction with each mode's impulse response on the rest, as K8 does on
the card.  Inputs come from numpy with a seed: white noise, or for a padded
signal a decaying one (an RIR's shape).  Bars, each relative to max|P| over
the modes compared:

- the contraction alone (every mode), in np.longdouble, equals the loop in
  np.longdouble to <= 1e-13 (the index algebra; both are near exact there);
- the split is bitwise equal to `modal_recurrence_plain` on its loop modes
  and within 1e-12 of it over every mode, at 8 and 48 kHz, with and
  without pad_t, up to 12,000 samples; at 48,000 on the lowest and highest
  2 q0 modes and every 97th mode;
- the filter built on the split agrees with the JAX package's `lax.scan`
  (`apply_modal_filter(use_jax=True)`) to 1e-12.
"""

import functools

import numpy as np
import pytest
import torch
from scipy.fft import idct

from pffdtd_tpu.analysis import air_abs as jair

from pffdtd_tpu_torch.analysis.air_abs import (_modal_setup,
                                               modal_recurrence_plain)
from pffdtd_tpu_torch.kernels.modal import (_contract, loop_modes,
                                            modal_split_plain, serial_modes)

torch.set_num_threads(2)

PAD_T = 0.01


def _signal(nt0, Fs, decay, seed):
    x = np.random.default_rng(seed).standard_normal((2, nt0))
    if decay:
        x *= np.exp(-np.arange(nt0) / (0.05 * Fs))
    return x


def _split(setup, modes):
    a1, a2, F1, F2, u = setup
    t = torch.from_numpy
    return modal_split_plain(t(a1[modes]), t(a2[modes]),
                             t(np.ascontiguousarray(F1[:, modes])),
                             t(np.ascontiguousarray(F2[:, modes])), t(u),
                             t(modes)).numpy()


@functools.lru_cache(maxsize=None)
def _case(nt0, Fs, pad):
    """The split and the numpy loop over every mode; a padded signal
    decays."""
    setup = _modal_setup(_signal(nt0, Fs, pad, nt0 + int(Fs)), Fs, 20.0,
                         50.0, PAD_T if pad else 0.0)
    nt = setup[4].shape[1] - 1
    return nt, _split(setup, np.arange(nt)), modal_recurrence_plain(*setup)


CASES = [(nt0, Fs, pad) for nt0 in (1, 2, 130, 960, 2052, 4800, 12000)
         for Fs in (8000.0, 48000.0) for pad in (False, True)]


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("nt0, Fs, pad", CASES)
def test_split_matches_loop(nt0, Fs, pad):
    nt, P, Pn = _case(nt0, Fs, pad)
    assert P.shape == Pn.shape == (2, nt)
    assert _rel(P, Pn) <= 1e-12


@pytest.mark.parametrize("nt0, Fs, pad", CASES)
def test_split_loop_modes_bitwise(nt0, Fs, pad):
    nt, P, Pn = _case(nt0, Fs, pad)
    ser = loop_modes(np.arange(nt), nt)
    assert ser.any()
    assert np.array_equal(P[:, ser], Pn[:, ser])


@pytest.mark.parametrize("Fs, decay", [(48000.0, False), (8000.0, True)])
def test_split_at_48000_on_a_mode_subset(Fs, decay):
    nt = 48000
    setup = _modal_setup(_signal(nt, Fs, decay, 7), Fs, 20.0, 50.0, 0.0)
    q0 = serial_modes(nt)
    modes = np.unique(np.r_[np.arange(2 * q0), np.arange(nt - 2 * q0, nt),
                            np.arange(0, nt, 97)])
    a1, a2, F1, F2, u = setup
    Pn = modal_recurrence_plain(a1[modes], a2[modes], F1[:, modes],
                                F2[:, modes], u)
    P = _split(setup, modes)
    assert _rel(P, Pn) <= 1e-12
    ser = loop_modes(modes, nt)
    assert np.array_equal(P[:, ser], Pn[:, ser])


@pytest.mark.skipif(np.finfo(np.longdouble).eps >= 1e-18,
                    reason="np.longdouble is no wider than float64 here")
@pytest.mark.parametrize("nt0, Fs", [(130, 48000.0), (2052, 8000.0),
                                     (4800, 48000.0)])
def test_contraction_equals_loop_in_extended_precision(nt0, Fs):
    setup = _modal_setup(_signal(nt0, Fs, False, 3), Fs, 20.0, 50.0, 0.0)
    ld = [np.asarray(a, np.longdouble) for a in setup]
    C, L = _contract(*ld), modal_recurrence_plain(*ld)
    assert C.dtype == np.longdouble
    assert _rel(C, L) <= 1e-13


@pytest.mark.parametrize("Fs, pad", [(8000.0, False), (48000.0, True)])
def test_split_filter_matches_jax(Fs, pad):
    x = _signal(4800, Fs, pad, 11)
    pad_t = PAD_T if pad else 0.0
    setup = _modal_setup(x, Fs, 20.0, 50.0, pad_t)
    nt = setup[4].shape[1] - 1
    y = idct(_split(setup, np.arange(nt)), type=2, norm="ortho", axis=-1)
    yj = jair.apply_modal_filter(x, Fs, 20.0, 50.0, pad_t=pad_t,
                                 use_jax=True)
    assert y.shape == yj.shape
    assert _rel(y, yj) <= 1e-12


def test_serial_modes_rule():
    nts = np.r_[np.arange(1, 3000), [4800, 12000, 48000, 96000, 10**6]]
    q0s = [serial_modes(int(n)) for n in nts]
    assert all(1 <= q <= n for q, n in zip(q0s, nts))
    assert all(a <= b for a, b in zip(q0s, q0s[1:]))   # grows with Nt
    assert serial_modes(1) == 1 and serial_modes(2) == 1
    with pytest.raises(ValueError):
        serial_modes(0)


def test_split_refuses_bad_arguments():
    setup = _modal_setup(_signal(64, 8000.0, False, 1), 8000.0, 20.0, 50.0,
                         0.0)
    a1, a2, F1, F2, u = map(torch.from_numpy, setup)
    modes = torch.arange(64)
    assert modal_split_plain(a1, a2, F1, F2, u, modes).shape == (2, 64)
    with pytest.raises(ValueError, match="lie in"):
        modal_split_plain(a1, a2, F1, F2, u, modes + 1)
    with pytest.raises(ValueError, match="Nq"):
        modal_split_plain(a1[:-1], a2, F1, F2, u, modes)
    with pytest.raises(ValueError, match="Nq"):
        modal_split_plain(a1, a2, F1, F2[:1], u, modes)
