"""K1, the stencil step (`stencil_step_kernel`, csrc/stencil.cu): one
leapfrog step on every interior point.

Bytes: u^{n-1}, u^n and the packed adjacency (uint16 for the 12 FCC legs,
uint8 for the 6 Cartesian) read, u^{n+1} written.  Operations: the sum of
the NN neighbours, then (2 - sl2 K) u^n - u^{n-1} + a2 sum: NN + 4."""

from rirbench.roofline import interior

KERNEL = "stencil_step_kernel"


def cost(run: dict) -> tuple:
    n = interior(run["grid"])
    adj = 2 if run["fcc"] else 1
    nn = 12 if run["fcc"] else 6
    return n * (3 * run["itemsize"] + adj), n * (nn + 4)
