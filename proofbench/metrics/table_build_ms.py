"""table_build_ms: the sweep's table build a call (upload, pool hash,
hint pass, expansion; the program's own synced span,
SweepResult.pack_seconds), the mean over every call of the traced run's
window, in ms."""

UNIT = "ms"


def read(t):
    v = t.spans.get("table_build_ms") or []
    return sum(v) / len(v) if v else None
