"""The port's spans (`utils.profiling.span`) on the CPU: while no profiler
runs a span is one shared object that enters no `record_function`; under
torch.profiler one served request, one epoch sweep and one two-level
storage call leave every span of the port in the Chrome trace, each
inside its parent on the same thread; and the results are the same with
the profiler on and off."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zk_state_proofs_tpu_torch.models import (BatchVerifier, sweep_resident_epochs,
                                              verify_storage_grouped)
from zk_state_proofs_tpu_torch.utils import profiling
from zk_state_proofs_tpu_torch.utils.config import BucketConfig
from zk_state_proofs_tpu_torch.witness_bridge import account_entries, storage_world, sweep_world

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

SERVICE_SPANS = ("zkp.service.verify", "zkp.service.sort", "zkp.pack", "zkp.pack.proofs",
                 "zkp.pack.pool", "zkp.copy_in", "zkp.to_host", "zkp.verify", "zkp.hash",
                 "zkp.walk", "zkp.walk.rerun")
SWEEP_SPANS = ("zkp.sweep", "zkp.sweep.tables", "zkp.sweep.upload", "zkp.hash",
               "zkp.sweep.expand", "zkp.sweep.windows", "zkp.sweep.window", "zkp.walk",
               "zkp.walk.rerun", "zkp.sweep.drain")
STORAGE_SPANS = ("zkp.storage", "zkp.storage.account", "zkp.storage.slot_keys",
                 "zkp.storage.slots")
# child -> the spans one of which holds each of its events
PARENTS = {
    "zkp.service.sort": ("zkp.service.verify",),
    "zkp.pack": ("zkp.service.verify",),
    "zkp.pack.proofs": ("zkp.pack",),
    "zkp.pack.pool": ("zkp.pack",),
    "zkp.copy_in": ("zkp.service.verify",),
    "zkp.verify": ("zkp.service.verify", "zkp.storage.account", "zkp.storage.slots"),
    "zkp.to_host": ("zkp.service.verify",),
    "zkp.hash": ("zkp.verify", "zkp.sweep.tables"),
    "zkp.walk": ("zkp.verify", "zkp.sweep.window"),
    "zkp.walk.rerun": ("zkp.walk",),
    "zkp.sweep.tables": ("zkp.sweep",),
    "zkp.sweep.upload": ("zkp.sweep.tables",),
    "zkp.sweep.expand": ("zkp.sweep.tables",),
    "zkp.sweep.windows": ("zkp.sweep",),
    "zkp.sweep.window": ("zkp.sweep.windows",),
    "zkp.sweep.drain": ("zkp.sweep",),
    "zkp.storage.account": ("zkp.storage",),
    "zkp.storage.slot_keys": ("zkp.storage",),
    "zkp.storage.slots": ("zkp.storage",),
}


def _refuse(*a, **k):
    raise AssertionError("record_function entered while no profiler runs")


@pytest.fixture
def no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)


@pytest.fixture(scope="module")
def world():
    """A depth-sorted service on 64 accounts with its depth and pool
    segments pinned (so a request sorts), a request of 40 of them in
    another order, a packed sweep witness of 48 accounts, and a two-level
    storage witness of 4 accounts with 4 slots each."""
    entries, _ = account_entries(64)
    proto = BatchVerifier(BucketConfig.account(), batch_size=64, device="cpu")
    proto.warmup(entries)
    first = proto.pack(entries)
    svc = BatchVerifier(BucketConfig.account(), batch_size=64, pool_rows=proto.pool_rows,
                        depth_segments=first.depth_segments(tile=16),
                        pool_segments=first.pool_block_segments(tile=16), device="cpu")
    svc.warmup(entries)
    request = [entries[i] for i in np.random.default_rng(3).permutation(64)[:40]]
    return svc, request, sweep_world(48).pack(), storage_world(4, 4, 16)


def _serve_and_sweep(world):
    svc, request, witness, sw = world
    res = svc.verify(request)
    swept = sweep_resident_epochs(witness, epochs=2, batch=16, salt=7, device="cpu")
    st = verify_storage_grouped(*sw.pack(), sw.slots, sw.slot_accounts, device="cpu")
    return ((res.status, res.values, res.value_lens),
            (swept.found, swept.excluded, swept.invalid, swept.total, swept.batches),
            (st.account_status, st.storage_root, st.slot_status, st.slot_values,
             st.slot_value_lens))


def test_span_is_a_shared_no_op_without_a_profiler(no_record_function):
    assert not torch.autograd.profiler._is_profiler_enabled
    s = profiling.span("zkp.test")
    assert s is profiling.span("zkp.other")
    with s:
        pass


def _events(trace_path):
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("zkp."):
            spans.setdefault(e["name"], []).append((e["tid"], e["ts"], e["ts"] + e["dur"]))
    return spans


def _inside(child, parents) -> bool:
    tid, a, b = child
    return any(ptid == tid and pa <= a and b <= pb for ptid, pa, pb in parents)


def test_profiled_request_and_sweep_hold_every_span_nested(world, tmp_path,
                                                           monkeypatch):
    svc = world[0]
    staged = svc.stats.staged_batches
    # off: no span of the port enters record_function
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _refuse)
        m.setattr(torch.autograd.profiler, "record_function", _refuse)
        off = _serve_and_sweep(world)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _serve_and_sweep(world)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _events(path)
    assert set(SERVICE_SPANS + SWEEP_SPANS + STORAGE_SPANS) == set(spans), sorted(spans)
    assert len(spans["zkp.service.verify"]) == 1 and len(spans["zkp.sweep"]) == 1
    assert len(spans["zkp.service.sort"]) == 2  # the sort, and the restore of order
    # both requests were packed pool first, the packer's spans in the request's
    assert svc.stats.staged_batches == staged + 2
    for name in ("zkp.pack.proofs", "zkp.pack.pool", "zkp.copy_in"):
        assert len(spans[name]) == 1 and _inside(spans[name][0], spans["zkp.service.verify"])
    # one loop span, and a span a window: 2 epochs of 3 windows of 16 rows
    assert len(spans["zkp.sweep.windows"]) == 1 and len(spans["zkp.sweep.window"]) == 6
    # one storage call: each level's pooled verify inside its own span
    assert all(len(spans[n]) == 1 for n in STORAGE_SPANS)
    for level in ("zkp.storage.account", "zkp.storage.slots"):
        assert sum(_inside(ev, spans[level]) for ev in spans["zkp.verify"]) == 1, level
    for child, parents in PARENTS.items():
        holders = [p for name in parents for p in spans[name]]
        for ev in spans[child]:
            assert _inside(ev, holders), (child, ev, parents)
    # the same answers with the profiler on and off
    for got, want in zip(on[0] + on[2], off[0] + off[2]):
        np.testing.assert_array_equal(got, want)
    assert on[1] == off[1]
    assert (on[2][2] == 1).all()  # every slot FOUND
