"""k1_roofline (%): K1's least time at the roof over its mean traced time."""

from rirbench.roofline import k1, kernel_share


def read(run):
    return kernel_share(run, k1.KERNEL, k1.cost)
