"""k3_roofline (%): K3's least time a sweep at the roof over its mean
traced time."""

from rirbench.roofline import k3, kernel_share


def read(run):
    return kernel_share(run, k3.KERNEL, k3.cost)
