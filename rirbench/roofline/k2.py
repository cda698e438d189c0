"""K2, the lossy-boundary update (`boundary_update_kernel`,
csrc/boundary.cu): the RLC-branch ODE at every lossy node.

Bytes a node: u^{n+1} read and written, u^{n-1} read, its index (int64),
surface factor and material index (int32) read, and the M branch states
vh and gh read and written, M the material's branches (the program pads
them to 12; the padding is not counted).  Operations a node: about 15 a
branch (the branch sum, vh' and gh') and 10 for the update of u."""

KERNEL = "boundary_update_kernel"


def cost(run: dict) -> tuple:
    s, m = run["itemsize"], run["branches"]
    per_node = 3 * s + 8 + s + 4 + 4 * m * s
    return run["Nbl"] * per_node, run["Nbl"] * (15 * m + 10)
