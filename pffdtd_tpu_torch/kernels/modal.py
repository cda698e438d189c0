"""K8, the modal air-absorption filter's recurrence, and its plain versions.

`modal_scan` launches `csrc/modal.cu` for tensors on the card and runs
`modal_scan_plain` for tensors on the CPU.  Both compute, for every
channel and mode, the recurrence of `analysis.air_abs.apply_modal_filter`
(the `lax.scan` of pffdtd_tpu/analysis/air_abs.py:157-169):

    P_new = ((a1 P_curr + a2 P_prev) + F1 u[:, n+1]) - F2 u[:, n]

for n = 0 .. Nt-1 from P_prev = P_curr = 0, into `out` = the final P_curr.
a1, a2: (Nt,); F1, F2, out: (Nch, Nt); u: (Nch, Nt + 1); all float64.

`modal_scan_plain` is the loop, each product and sum rounded on its own in
the numpy loop's order: it gives `modal_recurrence_plain`'s bits.  K8
splits the modes (`serial_modes`): the modes at both ends of the spectrum
run that loop, bit for bit; the others the contraction with the mode's
impulse response h (csrc/modal.cu), which reorders the sums and stays
within 1e-12 of max|P| of the loop.  `modal_split_plain` is the split in
PyTorch ops, on any set of modes: the tests' and the card's yardstick for
K8's design.
"""

from __future__ import annotations

import torch

from pffdtd_tpu_torch.kernels import _build

# Modes q < q0 and q >= Nt - q0 keep the loop: there the recurrence has a
# near-double root (theta_q = pi q / Nt near 0 or pi) and the loop's own
# rounding error exceeds what a reordering may differ by.  That error grows
# faster than Nt, so q0 = ceil(Nt / 48) up to SERIAL_NT samples and
# ceil(Nt^2 / (48 SERIAL_NT)) beyond; set on the CPU against the loop
# (`python -m pffdtd_tpu_torch.analysis.modal_accuracy`, PERF.md §6).
SERIAL_DIV, SERIAL_NT = 48, 48000


def serial_modes(nt: int) -> int:
    """q0 for `nt` samples: modes q < q0 and q >= nt - q0 run the loop
    (every mode when 2 q0 >= nt), the rest the contraction; 1 <= q0 <= nt."""
    if nt < 1:
        raise ValueError(f"nt = {nt}: want at least one sample")
    return min(nt, -(-nt * max(nt, SERIAL_NT) // (SERIAL_DIV * SERIAL_NT)))


def loop_modes(modes, nt):
    """Which of `modes` (mode indices, an array or a tensor) K8 runs on
    the loop for `nt` samples: q < q0 or q >= nt - q0."""
    q0 = serial_modes(nt)
    return (modes < q0) | (modes >= nt - q0)


def _check(a1, a2, F1, F2, u, out):
    if F1.dim() != 2:
        raise ValueError(f"F1: shape {tuple(F1.shape)}, want (Nch, Nt)")
    nch, nt = F1.shape
    shapes = {"a1": (nt,), "a2": (nt,), "F1": (nch, nt), "F2": (nch, nt),
              "u": (nch, nt + 1), "out": (nch, nt)}
    named = dict(a1=a1, a2=a2, F1=F1, F2=F2, u=u, out=out)
    for name, t in named.items():
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: dtype {t.dtype}, want float64")
        if tuple(t.shape) != shapes[name] or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {shapes[name]} "
                             f"tensor, got {tuple(t.shape)}")
    devs = {t.device for t in named.values()}
    if len(devs) != 1:
        raise ValueError(f"a1, a2, F1, F2, u and out must share one device, "
                         f"got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {dev}: cpu or cuda only")
    if out.data_ptr() in {t.data_ptr() for t in (a1, a2, F1, F2, u)}:
        raise ValueError("out must be a buffer of its own")
    return dev, nch, nt


def modal_scan(a1, a2, F1, F2, u, out):
    """The recurrence over every sample into `out`; returns out.  One K8
    launch on the card, whatever Nt."""
    dev, nch, nt = _check(a1, a2, F1, F2, u, out)
    if dev.type == "cpu":
        return modal_scan_plain(a1, a2, F1, F2, u, out)
    lib = _build.library()
    with _build.on_device(dev):
        rc = lib.pf_modal_recurrence(
            a1.data_ptr(), a2.data_ptr(), F1.data_ptr(), F2.data_ptr(),
            u.data_ptr(), out.data_ptr(), nch, nt, serial_modes(nt),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "modal_scan")
    modal_scan.launches += 1
    return out


modal_scan.launches = 0


def _loop(a1, a2, F1, F2, u):
    """The loop on modes of any number: a1, a2 (Nq,), F1, F2 (Nch, Nq), u
    (Nch, Nt + 1); returns the final P (Nch, Nq)."""
    uT = u.T.contiguous()[:, :, None]            # (Nt + 1, Nch, 1)
    P_prev, P_curr = torch.zeros_like(F1), torch.zeros_like(F1)
    P_new, tmp = torch.empty_like(F1), torch.empty_like(F1)
    for n in range(u.shape[-1] - 1):
        torch.mul(a1, P_curr, out=P_new)
        torch.mul(a2, P_prev, out=tmp)
        P_new += tmp
        torch.mul(F1, uT[n + 1], out=tmp)
        P_new += tmp
        torch.mul(F2, uT[n], out=tmp)
        P_new -= tmp
        P_prev, P_curr, P_new = P_curr, P_new, P_prev
    return P_curr


def _contract(a1, a2, F1, F2, u):
    """The contraction P = F1 A - F2 B with the modes' impulse responses h:
    A = sum_k h(k) u[:, Nt-k], B = sum_k h(k) u[:, Nt-1-k], k = 0 .. Nt-1,
    in K8's order.  Shapes as `_loop`'s; operators only, so that it runs on
    numpy arrays too (in extended precision, in the tests)."""
    nt = u.shape[-1] - 1
    h, h_prev = a1 * 0 + 1, a1 * 0
    A, B = F1 * 0, F1 * 0
    for k in range(nt):
        A += h * u[:, nt - k, None]
        B += h * u[:, nt - 1 - k, None]
        h, h_prev = a1 * h + a2 * h_prev, h
    return F1 * A - F2 * B


def modal_scan_plain(a1, a2, F1, F2, u, out):
    """PyTorch version of K8's recurrence (same signature and result): the
    loop, seven ops a sample on the tensors' device."""
    _check(a1, a2, F1, F2, u, out)
    return out.copy_(_loop(a1, a2, F1, F2, u))


def modal_split_plain(a1, a2, F1, F2, u, modes):
    """K8's design in PyTorch ops, on the modes `modes` (Nq,) of a signal
    u (Nch, Nt + 1) with a1, a2 (Nq,) and F1, F2 (Nch, Nq) those modes'
    coefficients, all float64 on one device: the loop (`modal_scan_plain`'s
    ops) on modes q < q0 or q >= Nt - q0, q0 = `serial_modes(Nt)`, the
    contraction on the rest.  Returns P (Nch, Nq)."""
    nt = u.shape[-1] - 1
    nq = modes.shape[0]
    if u.dim() != 2 or a1.shape != (nq,) or a2.shape != (nq,) or \
            F1.shape != (u.shape[0], nq) or F2.shape != F1.shape:
        raise ValueError("want a1, a2 (Nq,), F1, F2 (Nch, Nq) and u "
                         "(Nch, Nt + 1)")
    if nq and not 0 <= int(modes.min()) <= int(modes.max()) < nt:
        raise ValueError(f"modes must lie in [0, {nt})")
    ser = loop_modes(modes, nt)
    P = torch.empty_like(F1)
    for pick, fn in ((ser, _loop), (~ser, _contract)):
        if pick.any():
            P[:, pick] = fn(a1[pick], a2[pick], F1[:, pick], F2[:, pick], u)
    return P
