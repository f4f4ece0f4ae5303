"""exact_reruns_per_request: the slot level's guarded `exact` launches that
walked (the batch walked a second time because a proof latched the
`bounded` walk's overflow flag), a request: the port's device tally
(ops.mpt_cuda.exact_walked) over the requests since the set-up, less the
account level's own, read by the driver after the window."""

UNIT = "launches"


def read(t):
    v = t.spans.get("exact_reruns_per_request") or []
    return sum(v) / len(v) if v else None
