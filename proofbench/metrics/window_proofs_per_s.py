"""window_proofs_per_s: proofs_per_s as the traced run reads it, for a cell
whose runs spread too widely for proofs_per_s to hold a bound end to end:
every proof answered in the window over the whole window, the profiled
stretch (its requests, and its wall time from the profiler's start to its
stop) left out; in proofs/s."""

UNIT = "proofs/s"


def read(t):
    u = t.untraced
    if not u or u["seconds"] <= 0 or u["proofs"] <= 0:
        return None
    return u["proofs"] / u["seconds"]
