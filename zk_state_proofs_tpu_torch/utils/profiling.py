"""Throughput meter and a CUDA-event timer."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Meter:
    """Accumulates per-step stats for a verification run."""

    proofs: int = 0
    nodes_hashed: int = 0
    bytes_hashed: int = 0
    seconds: float = 0.0
    steps: int = 0

    def record(self, batch: int, nodes: int, nbytes: int, dt: float) -> None:
        self.proofs += batch
        self.nodes_hashed += nodes
        self.bytes_hashed += nbytes
        self.seconds += dt
        self.steps += 1

    def summary(self) -> dict:
        s = max(self.seconds, 1e-9)
        return {
            "proofs_per_sec": self.proofs / s,
            "hashes_per_sec": self.nodes_hashed / s,
            "bytes_hashed_per_sec": self.bytes_hashed / s,
            "steps": self.steps,
            "seconds": self.seconds,
        }


def cuda_timer(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of `fn(i)` over `iters` calls,
    timed with CUDA events on the current stream. `fn` receives the
    iteration index so each call can be distinct work. Raises without a
    CUDA device: a device time cannot come from the host."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_timer needs a CUDA device")
    for i in range(warmup):
        fn(-1 - i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_profile(fn, iters: int, top: int = 8) -> dict:
    """`fn(i)` for `iters` calls under torch.profiler, after one warm-up
    call. Returns the host wall ms per call, the device busy ms per call
    (the sum of kernel and copy times, which do not overlap on one
    stream), the device launches per call, and the `top` kernels by device
    time as (name, ms per call, launches per call)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall * 1e3 / iters, "busy_ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows), "top": rows[:top]}
