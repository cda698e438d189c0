"""step_roofline (%): the least time of the traced simulation's kernels at
the roof (Nt steps of K1 + K2 on the step route; Nt // TB sweeps of K3
and Nt % TB steps of K1 + K2 on the tb route) over the simulation's wall
time: every step's share of the roofline, gaps and all."""

from rirbench.roofline import k1, k2, k3, least_seconds


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    s = run["itemsize"]
    step = least_seconds(*k1.cost(run), s) + least_seconds(*k2.cost(run), s)
    nt = run["Nt"]
    if run["route"] == "step":
        t = nt * step
    else:
        tb = run["TB"]
        t = nt // tb * least_seconds(*k3.cost(run), s) + nt % tb * step
    return 100.0 * t / tr["window_s"]
