"""K3, the temporally blocked sweep (`tb_sweep_kernel`, csrc/tb.cu): TB
steps of K1 and K2 in one pass over the grid.

Bytes a sweep: u^{n-1}, u^n and the adjacency read, u^{n+TB-1} and
u^{n+TB} written on every interior point; at every lossy node its index,
surface factor and material index read and the M branch states vh and gh
read and written once.  The per-tile lists of nodes that the kernel also
reads are its own index, derived from the node list, and are not counted.
Operations: TB times K1's and K2's."""

from rirbench.roofline import interior, k1, k2

KERNEL = "tb_sweep_kernel"


def cost(run: dict) -> tuple:
    s, m, tb = run["itemsize"], run["branches"], run["TB"]
    adj = 2 if run["fcc"] else 1
    grid = interior(run["grid"]) * (4 * s + adj)
    nodes = run["Nbl"] * (8 + s + 4 + 4 * m * s)
    flops = tb * (k1.cost(run)[1] + k2.cost(run)[1])
    return grid + nodes, flops
