"""k2_roofline (%): K2's least time at the roof over its mean traced time."""

from rirbench.roofline import k2, kernel_share


def read(run):
    return kernel_share(run, k2.KERNEL, k2.cost)
