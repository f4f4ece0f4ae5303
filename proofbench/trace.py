"""The traced stretch of a window: torch.profiler over a run of requests,
its Chrome trace written under TMPDIR and read back into what the
per-layer metrics take: device operations, host launch calls, the device's
busy time, idle gaps by what the host was doing, and each kernel group's
records held against the port's launch counters."""

from __future__ import annotations

import bisect
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def _counters() -> dict:
    from zk_state_proofs_tpu_torch.ops._build import LAUNCH_COUNTS

    return {k: v for counts in LAUNCH_COUNTS for k, v in counts.items()}


def load_groups(root: Path) -> dict:
    """Kernel groups: metrics/kernels/<group>/*.json, each {"kernels": [name
    parts], "counters": [launch counter names]}, every file of a group
    joined."""
    groups = {}
    for d in sorted((root / "metrics" / "kernels").iterdir()):
        if not d.is_dir():
            continue
        g = {"kernels": [], "counters": []}
        for f in sorted(d.glob("*.json")):
            spec = json.loads(f.read_text())
            g["kernels"] += spec.get("kernels", [])
            g["counters"] += spec.get("counters", [])
        groups[d.name] = g
    return groups


class Stretch:
    """Profiles requests from start() to stop(); read() parses the trace."""

    def __init__(self, label: str, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)
        self.cuda = cuda
        self.path = Path(tempfile.gettempdir()) / "proofbench" / f"{label}.trace.json"
        self.requests = []
        self.t0 = self.t1 = None
        self.w0 = self.w1 = None  # the stretch's wall time, the profiler's start and stop included
        self.before = self.after = None

    def warm_up(self, request) -> None:
        """Profile one request and drop it: the profiler's first start in a
        process sets up its tracing, which takes seconds."""
        from torch.profiler import profile

        with profile(activities=self.prof.activities):
            request()
            self._sync()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self.w0 = time.perf_counter()
        self._sync()
        self.before = _counters()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        self._sync()
        self.prof.stop()
        self.after = _counters()
        self.w1 = time.perf_counter()

    def read(self, groups: dict) -> "Reading":
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        events = json.loads(self.path.read_text()).get("traceEvents", [])
        print(f"trace: {len(events)} events in {self.path}", file=sys.stderr, flush=True)
        return Reading(events, self, groups)


class Reading:
    """What a trace says about its stretch of `requests` requests."""

    def __init__(self, events, st: Stretch, groups: dict):
        self.requests = len(st.requests)
        self.request_ids = list(st.requests)
        self.window_s = st.t1 - st.t0
        self.groups = groups
        self.device = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                              for e in events if e.get("ph") == "X"
                              and e.get("cat") in DEVICE_CATS), key=lambda x: x[0])
        self.kernel_records = [(e["name"], e.get("dur", 0)) for e in events
                               if e.get("ph") == "X" and e.get("cat") == "kernel"]
        self.launch_calls = sum(1 for e in events if e.get("ph") == "X"
                                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                                and e.get("name") in LAUNCH_CALLS)
        self.host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.counted = {k: st.after[k] - st.before.get(k, 0) for k in st.after}
        self.busy_s = self._busy()
        self.work = []
        self.spans = {}
        self.untraced = None

    def _busy(self) -> float:
        total, end = 0.0, None
        start = None
        for a, b, _ in self.device:
            if end is None or a > end:
                if end is not None:
                    total += end - start
                start, end = a, b
            else:
                end = max(end, b)
        if end is not None:
            total += end - start
        return total / 1e6

    def group_records(self, group: str):
        names = self.groups.get(group, {}).get("kernels", [])
        return [(n, d) for n, d in self.kernel_records if any(p in n for p in names)]

    def group_launches(self, group: str) -> int:
        return sum(self.counted.get(c, 0) for c in self.groups.get(group, {}).get("counters", []))

    def kernel_ms(self, group: str):
        """The group's device ms over the stretch, or None where no record
        of it was taken. Where the trace holds fewer records than the
        port counted launches, the records' mean stands for the missing
        ones (the cross-check line says so)."""
        recs = self.group_records(group)
        if not recs:
            return None
        ms = sum(d for _, d in recs) / 1e3
        launched = self.group_launches(group)
        if launched > len(recs):
            ms *= launched / len(recs)
        return ms

    def roofline(self, group: str):
        """100 x the least time of the traced requests' work of the group
        (each request's `work`, from the frozen bounds) over the group's
        device time; None where either is missing."""
        bound = sum(w.get(group, 0.0) for w in self.work)
        ms = self.kernel_ms(group)
        if ms is None or ms <= 0 or bound <= 0:
            return None
        return 100.0 * bound / ms

    def idle_pct(self):
        """100 x (1 - device busy / wall) over the stretch."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def launches_per_request(self):
        if self.requests == 0 or self.launch_calls == 0:
            return None
        return self.launch_calls / self.requests

    def cross_check(self) -> str:
        parts = []
        for g in sorted(self.groups):
            parts.append(f"{g} {len(self.group_records(g))} records / "
                         f"{self.group_launches(g)} launches")
        return "trace check (kernel records / the port's launch counters): " + "; ".join(parts)

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for a, b, n in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
        gaps: dict = {}
        host = sorted(self.host, key=lambda h: h[0])
        starts = [h[0] for h in host]
        prev_end = None
        for a, b, _ in self.device:
            if prev_end is not None and a > prev_end:
                name = _host_at(host, starts, (prev_end + a) / 2)
                gaps[name] = gaps.get(name, 0.0) + (a - prev_end) / 1e6
            prev_end = b if prev_end is None else max(prev_end, b)
        srt = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": srt(ops), "idle_gaps": srt(gaps)}


def _host_at(host, starts, t, reach: int = 256) -> str:
    """The innermost host event running at t: host events nest, so it is
    the latest-starting one that still covers t."""
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(i - reach, -1), -1):
        if host[k][1] >= t:
            return host[k][2]
    return "(host, untraced)"
