"""K8, the modal air-absorption filter's recurrence, and its plain version.

`modal_scan` launches `csrc/modal.cu` for tensors on the card and runs
`modal_scan_plain` for tensors on the CPU.  Both compute, for every
channel and mode, the recurrence of `analysis.air_abs.apply_modal_filter`
(the `lax.scan` of pffdtd_tpu/analysis/air_abs.py:157-169):

    P_new = ((a1 P_curr + a2 P_prev) + F1 u[:, n+1]) - F2 u[:, n]

for n = 0 .. Nt-1 from P_prev = P_curr = 0, into `out` = the final P_curr.
a1, a2: (Nt,); F1, F2, out: (Nch, Nt); u: (Nch, Nt + 1); all float64.
Each product and sum rounds on its own, in the numpy loop's order, so both
give `modal_recurrence_plain`'s bits.
"""

from __future__ import annotations

import torch

from pffdtd_tpu_torch.kernels import _build


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
    rc = lib.pf_modal_recurrence(
        a1.data_ptr(), a2.data_ptr(), F1.data_ptr(), F2.data_ptr(),
        u.data_ptr(), out.data_ptr(), nch, nt,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "modal_scan")
    modal_scan.launches += 1
    return out


modal_scan.launches = 0


def modal_scan_plain(a1, a2, F1, F2, u, out):
    """PyTorch version of K8 (same signature and result): seven ops a
    sample on the tensors' device."""
    _check(a1, a2, F1, F2, u, out)
    uT = u.T.contiguous()[:, :, None]            # (Nt + 1, Nch, 1)
    P_prev, P_curr = torch.zeros_like(F1), torch.zeros_like(F1)
    P_new, tmp = torch.empty_like(F1), torch.empty_like(F1)
    for n in range(F1.shape[-1]):
        torch.mul(a1, P_curr, out=P_new)
        torch.mul(a2, P_prev, out=tmp)
        P_new += tmp
        torch.mul(F1, uT[n + 1], out=tmp)
        P_new += tmp
        torch.mul(F2, uT[n], out=tmp)
        P_new -= tmp
        P_prev, P_curr, P_new = P_curr, P_new, P_prev
    return out.copy_(P_curr)
