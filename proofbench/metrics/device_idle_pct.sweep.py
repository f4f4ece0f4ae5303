"""device_idle_pct.sweep: 100 x (1 - device busy / wall) over the traced
stretch; busy is the union of the trace's kernels, copies and fills.

The sweep's copy of device_idle_pct, which moves proofs_per_s: the sweep
cell reports no request_ms_p95."""

UNIT = "%"


def read(t):
    return t.idle_pct()
