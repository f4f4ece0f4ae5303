"""sweep_dispatch_ms: host ms of the sweep's window loop, queueing every
window (SweepResult.dispatch_seconds), a call: the program's span
`zkp.sweep.windows` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.sweep.windows")
