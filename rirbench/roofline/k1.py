"""K1, the stencil step (`stencil_step_kernel`, csrc/stencil.cu): one
leapfrog step on every interior point.

Bytes: u^{n-1} and u^n read and u^{n+1} written at every interior point,
and the adjacency read: the run's `k1_adj_bytes` (`program.k1_adj_bytes`:
on the step route the compact form's mask, bases and legs, elsewhere the
packed grid); where the run lacks the key, the packed grid's uint16 for
the 12 FCC legs, uint8 for the 6 Cartesian.  Operations: the sum of the NN
neighbours, then (2 - sl2 K) u^n - u^{n-1} + a2 sum: NN + 4."""

from rirbench.roofline import interior

KERNEL = "stencil_step_kernel"


def cost(run: dict) -> tuple:
    n = interior(run["grid"])
    adj = run.get("k1_adj_bytes", n * (2 if run["fcc"] else 1))
    nn = 12 if run["fcc"] else 6
    return 3 * run["itemsize"] * n + adj, n * (nn + 4)
