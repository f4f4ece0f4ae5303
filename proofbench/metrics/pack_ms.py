"""pack_ms: host ms of the serving layer's BatchVerifier.pack, a request,
the mean over every request of the traced run's window (a host clock the
driver wraps around it in traced runs only)."""

UNIT = "ms"


def read(t):
    v = t.spans.get("pack_ms") or []
    return sum(v) / len(v) if v else None
