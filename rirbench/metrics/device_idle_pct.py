"""device_idle_pct (%): the share of the traced simulation in which the
card ran no kernel, copy or set."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
