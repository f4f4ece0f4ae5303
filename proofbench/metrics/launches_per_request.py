"""launches_per_request: the host's CUDA launch calls (cudaLaunchKernel,
cuLaunchKernel, cudaGraphLaunch and their kin, from torch.profiler's host
records) over the traced requests."""

UNIT = "launches"


def read(t):
    return t.launches_per_request()
