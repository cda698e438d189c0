"""kernels_per_step (count): the device operations (kernels, copies, sets)
of the traced simulation over its steps."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return len(tr["ops"]) / run["Nt"]
