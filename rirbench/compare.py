"""The numbers that decide `correct`: the program's outputs against the
plain reference's, each as the largest gap over the reference's largest
magnitude.

- `rx_err`: the receivers' signals (Nr, Nt) of a simulation.
- `field_err`: the final pressure field u^Nt on the grid's interior.  The
  program holds it rotated and, on FCC, folded across mid-y; the reference
  on the natural grid (on FCC its even-parity points only).  The rotation
  is read off the two shapes (each axis has its own length here), the
  fold is undone by its definition: folded row j holds natural row j at
  the points of even parity and natural row Ny-1-j at the others.  Halo and fold-ghost layers are never read by the
  scheme and are left out.
- `branch_err`: the walls' branch states vh at the end, at every lossy
  node, over the reference's largest |vh|.  The source keeps the field's
  largest values near itself (the differentiated impulse drives it at
  Nyquist to the end), so `field_err` weighs the walls little; vh is
  K2's (or K3's boundary's) own output, and zero where it never ran."""

from __future__ import annotations

import itertools

import numpy as np
import torch


def rx_err(prog, ref) -> float:
    prog, ref = np.asarray(prog), np.asarray(ref)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return float("inf")
    return float(np.abs(prog - ref).max() / np.abs(ref).max())


def _layout(prog_shape, nat_shape, folded):
    """(rot, tr): the program's grid unfolded, and the permutation tr with
    nat_shape[tr[d]] == rot[d]; tr None if there is none or more than
    one."""
    px, py, pz = prog_shape
    rot = (px, 2 * (py - 1) if folded else py, pz)
    found = [tr for tr in itertools.permutations(range(3))
             if all(nat_shape[tr[d]] == rot[d] for d in range(3))]
    return rot, found[0] if len(found) == 1 else None


def _program_index(nat, nat_shape, prog_shape, folded):
    """Flat indices in the program's layout of natural flat indices; None
    if the layouts cannot be matched."""
    _, py, pz = prog_shape
    rot, tr = _layout(prog_shape, nat_shape, folded)
    if tr is None:
        return None
    n1, n2 = nat_shape[1], nat_shape[2]
    sub = (nat // (n1 * n2), (nat // n2) % n1, nat % n2)
    a, y, c = (sub[tr[d]] for d in range(3))
    if folded:
        y = torch.where(y >= rot[1] // 2, rot[1] - 1 - y, y)
    return (a * py + y) * pz + c


def branch_err(vh_p: torch.Tensor, nodes_p: torch.Tensor,
               vh_r: torch.Tensor, nodes_r: torch.Tensor, R_shape,
               P_shape, folded: bool, scale: float = 1.0) -> float:
    """max |scale vh_p - vh_r| over the reference's lossy nodes and
    branches / max |vh_r|.  vh_p (>= M, Nbl): the program's branch states
    at its nodes nodes_p (flat indices of its layout, ascending); vh_r
    (M, Nl): the reference's at natural flat indices nodes_r; inf if a
    node of either is missing from the other."""
    idx = _program_index(nodes_r, R_shape, P_shape, folded)
    if idx is None or nodes_p.numel() != nodes_r.numel():
        return float("inf")
    pos = torch.searchsorted(nodes_p, idx).clamp(max=nodes_p.numel() - 1)
    if not torch.equal(nodes_p[pos], idx):
        return float("inf")
    m = vh_r.shape[0]
    r = vh_r.to(torch.float64)
    p = vh_p[:m, pos].to(torch.float64) * scale
    out = float((p - r).abs().max() / r.abs().max())
    return out if np.isfinite(out) else float("inf")


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, a and b in one layout (the control against
    the reference)."""
    out = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()
                / b.abs().max().to(torch.float64))
    return out if np.isfinite(out) else float("inf")


def field_err(P: torch.Tensor, R: torch.Tensor, Nn, stored, folded: bool,
              scale: float = 1.0, block: int = 32) -> float:
    """max |scale P - R| over the program's interior / max |R|, P in
    the program's layout and units (`scale` takes them to the
    reference's), R the reference's stored grid of the natural shape `Nn`
    (`stored` maps natural flat indices to R's); inf if the layouts
    cannot be matched."""
    px, py, pz = P.shape
    rot, tr = _layout(P.shape, Nn, folded)
    if tr is None:
        return float("inf")
    stride = (Nn[1] * Nn[2], Nn[2], 1)
    dev = P.device
    j = torch.arange(1, py - 1, device=dev)[None, :, None]
    c = torch.arange(1, pz - 1, device=dev)[None, None, :]
    Rf = R.reshape(-1)
    worst = torch.zeros((), dtype=torch.float64, device=dev)
    for a0 in range(1, px - 1, block):
        a = torch.arange(a0, min(a0 + block, px - 1), device=dev)[:, None,
                                                                  None]
        y = j
        if folded:
            y = torch.where((a + j + c) % 2 == 0, j, rot[1] - 1 - j)
        idx = (a * stride[tr[0]] + y * stride[tr[1]] + c * stride[tr[2]])
        gap = (P[a0:a0 + a.shape[0], 1:py - 1, 1:pz - 1].to(torch.float64)
               * scale - Rf[stored(idx)].to(torch.float64)).abs().max()
        worst = torch.maximum(worst, gap)
    out = float(worst / R.abs().max().to(torch.float64))
    return out if np.isfinite(out) else float("inf")
