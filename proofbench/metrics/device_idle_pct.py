"""device_idle_pct: 100 x (1 - device busy / wall) over the traced stretch;
busy is the union of the trace's kernels, copies and fills."""

UNIT = "%"


def read(t):
    return t.idle_pct()
