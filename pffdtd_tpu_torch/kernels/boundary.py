"""K2, the lossy-boundary update, and its plain PyTorch version.

`boundary_update` launches the CUDA kernel of `csrc/boundary.cu` for tensors
on the card, and runs `boundary_update_plain` for tensors on the CPU.  Both
update, in place, `unew` at the lossy nodes and the branch states `vh`, `gh`
((MMb, Nbl) each), exactly as `pffdtd_tpu/engine/jax_engine.py:667-678`:

    ub  = unew[bnl],  u2b = u0[bnl]
    ub  = (ub - l*ssaf*sum(2*bDh*vh - bFh*gh) + lo2*ssaf*beta*u2b)
          / (1 + lo2*ssaf*beta)
    vh' = b*(ub - u2b) + bd*vh - 2*bFh*gh;   gh' = gh + (vh' + vh)/2

`coef_table` is (Nmat+1, 4, MMb) = b | bd | bDh | bFh per material and `mat`
the per-node row.

`abcq`, (Nbl,) uint8 or None, is Q a node for scenes where lossy nodes lie
on an ABC layer (`EngineData.abcq_bnl`).  The reference runs the ABC after
the ODE (jax_engine.py:680-683); K1 has already applied it, so at a node
with Q > 0 (lQ = l*Q in the working precision, K1's value) the update first
undoes it, runs the ODE and the branch update on that value, then applies
the ABC to the value it writes:

    ub = ub*(1 + lQ) - lQ*u2b;   ... the ODE ...;   ub = (ub + lQ*u2b)/(1 + lQ)

With abcq None the kernel launches the instance without that code, K2 as it
was.  Node and material indices are not range-checked per call
(that would cost a device sync each step); `EngineData` builds them in range.
"""

from __future__ import annotations

import torch

from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.utils import as_dtype


def _check(unew, u0, bnl, ssaf, mat, coef_table, beta, vh, gh, abcq):
    dt = unew.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unew: dtype {dt}, want float32/float64")
    if u0.shape != unew.shape or not (unew.is_contiguous()
                                      and u0.is_contiguous()):
        raise ValueError("unew, u0: want contiguous grids of one shape")
    nbl = bnl.numel()
    want = {"u0": (u0, dt, None), "bnl": (bnl, torch.int64, (nbl,)),
            "ssaf": (ssaf, dt, (nbl,)), "mat": (mat, torch.int32, (nbl,)),
            "coef_table": (coef_table, dt, (beta.numel(), 4, MMb)),
            "beta": (beta, dt, (beta.numel(),)),
            "vh": (vh, dt, (MMb, nbl)), "gh": (gh, dt, (MMb, nbl))}
    if abcq is not None:
        want["abcq"] = (abcq, torch.uint8, (nbl,))
    for name, (t, tdt, shape) in want.items():
        if t.dtype != tdt:
            raise TypeError(f"{name}: dtype {t.dtype}, want {tdt}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != unew.device:
            raise ValueError(f"{name}: on {t.device}, unew on {unew.device}")
    if unew.data_ptr() == u0.data_ptr():
        raise ValueError("unew and u0 must be distinct buffers")
    return nbl


def abc_lq(sc, dt):
    """l*Q for Q = 1, 2, 3, rounded to dt as K1 rounds them."""
    return [as_dtype(sc.l * q, dt) for q in (1, 2, 3)]


def boundary_update(unew, u0, bnl, ssaf, mat, coef_table, beta, vh, gh, sc,
                    abcq=None):
    """One K2 update, in place on unew, vh and gh; returns unew.

    unew: the new field after K1; u0: u^{n-1} (untouched by K1);
    bnl (Nbl,) int64 flat node indices; ssaf (Nbl,); mat (Nbl,) int32;
    vh, gh (MMb, Nbl); sc: SchemeCoeffs (l, lo2); abcq: (Nbl,) uint8 Q a
    node, or None when no lossy node lies on an ABC layer."""
    nbl = _check(unew, u0, bnl, ssaf, mat, coef_table, beta, vh, gh, abcq)
    if unew.device.type == "cpu":
        return boundary_update_plain(unew, u0, bnl, ssaf, mat, coef_table,
                                     beta, vh, gh, sc, abcq)
    if unew.device.type != "cuda":
        raise ValueError(f"device {unew.device}: cpu or cuda only")
    if nbl == 0:
        return unew
    lib = _build.library()
    with _build.on_device(unew.device):
        rc = lib.pf_boundary_update(
            0 if unew.dtype == torch.float32 else 1, unew.data_ptr(),
            u0.data_ptr(), bnl.data_ptr(), ssaf.data_ptr(), mat.data_ptr(),
            coef_table.data_ptr(), beta.data_ptr(), vh.data_ptr(),
            gh.data_ptr(), nbl, sc.l, sc.lo2,
            None if abcq is None else abcq.data_ptr(),
            *abc_lq(sc, unew.dtype),
            torch.cuda.current_stream(unew.device).cuda_stream)
    _build.check(rc, "boundary_update")
    boundary_update.launches += 1
    return unew


boundary_update.launches = 0


def boundary_update_plain(unew, u0, bnl, ssaf, mat, coef_table, beta, vh, gh,
                          sc, abcq=None):
    """Gather/scatter PyTorch version of K2 (same signature and result, bit
    for bit: the same operations in the same order).

    Gathers per-node (MMb, Nbl) coefficient rows, which the kernel never
    materialises."""
    if bnl.numel() == 0:
        return unew
    dt = unew.dtype
    uf = unew.view(-1)
    ub = uf[bnl]
    u2b = u0.view(-1)[bnl]
    rows = coef_table[mat.long()]                    # (Nbl, 4, MMb)
    b, bd, bDh, bFh = (rows[:, q, :].T for q in range(4))
    l = torch.full((), sc.l, dtype=dt, device=unew.device)
    lo2 = torch.full((), sc.lo2, dtype=dt, device=unew.device)
    if abcq is not None:    # undo K1's ABC at the nodes with Q > 0
        on = abcq > 0
        lQ = torch.tensor([0.0, *abc_lq(sc, dt)], dtype=dt,
                          device=unew.device)[abcq.long()]
        ub = torch.where(on, ub * (1.0 + lQ) - lQ * u2b, ub)
    lo2Kbg = lo2 * ssaf * beta[mat.long()]
    # the branch sum in the kernel's order, j = 0..MMb-1: torch.sum adds in
    # an order of its own, and the two would differ in the last bit
    t = 2.0 * bDh * vh - bFh * gh
    s = t[0]
    for j in range(1, MMb):
        s = s + t[j]
    ub = ub - l * ssaf * s
    ub = (ub + lo2Kbg * u2b) / (1.0 + lo2Kbg)
    vh0 = b * (ub - u2b)[None, :] + bd * vh - 2.0 * bFh * gh
    gh.copy_(gh + 0.5 * (vh0 + vh))
    vh.copy_(vh0)
    if abcq is not None:    # the ABC after the ODE, as the reference
        ub = torch.where(on, (ub + lQ * u2b) / (1.0 + lQ), ub)
    uf[bnl] = ub
    return unew
