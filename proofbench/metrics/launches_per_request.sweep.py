"""launches_per_request.sweep: the host's CUDA launch calls
(cudaLaunchKernel, cuLaunchKernel, cudaGraphLaunch and their kin, from
torch.profiler's host records) over the traced requests.

The sweep's copy of launches_per_request, which moves proofs_per_s: the
sweep cell reports no request_ms_p95."""

UNIT = "launches"


def read(t):
    return t.launches_per_request()
