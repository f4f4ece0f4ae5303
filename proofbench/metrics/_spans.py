"""What the span metrics share: the host ms a request of the program's own
spans of one name (`zkp.<layer>[.<part>]`, `utils.profiling.span` in the
port), read from the traced stretch's host events."""


def per_request_ms(t, name: str):
    """The summed durations of the stretch's host events named `name`, in
    ms, over the stretch's requests; None where the trace holds none (a
    program without the span)."""
    durs = [b - a for a, b, n in t.host if n == name]
    if not durs or not t.requests:
        return None
    return sum(durs) / 1e3 / t.requests
