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
