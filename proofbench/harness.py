"""One run of one cell: find the cell's files by name, make the traffic from
the seed, set the system up, drive the window, read the trace, and decide
`correct` against the plain reference.

Everything is found by name under the benchmark's folder (`root`):
workloads/<cell>.json names a configuration and a traffic mix;
configs/<config>.json holds the deployment; traffic/<mix>.json names the
driver (drivers/<driver>.py) and its parameters; metrics/<metric>.py reads
one per-layer metric from a traced run, and metrics/kernels/<group>/*.json
name the kernels and launch counters of a kernel group. A metric that
BENCHMARK.json (beside the folder) gives a `workloads` list is reported in
those cells only.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from proofbench.traffic._population import Population, make_population

ROOT = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "zk_state_proofs_tpu")
KEEP = 24            # requests whose answers a run keeps for the comparison
TRACE_FROM = 0.25    # the traced stretch starts this far into the window
TRACE_SECONDS = 0.5  # and lasts this long
TRACE_MIN_REQUESTS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> dict:
    """The cell with its configuration and traffic mix filled in."""
    cell = load_json(root, "workloads", name)
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names {cell.get('name')!r}")
    cell["config"] = load_json(root, "configs", cell["config"])
    cell["mix"] = load_json(root, "traffic", cell["traffic"])
    return cell


def declared(root: Path) -> dict:
    """metric name -> the cells BENCHMARK.json (beside the benchmark's folder)
    reports it in, or None for every cell; {} where there is no
    BENCHMARK.json, so that every metric is reported."""
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        return {}
    bench = json.loads(path.read_text())
    return {m["name"]: m.get("workloads") for m in bench["end_to_end"] + bench["per_layer"]}


def reported(metrics: dict, cells: dict, cell: str) -> dict:
    """The metrics that the cell reports: those declared for it, and those
    declared for every cell or not declared at all."""
    return {k: v for k, v in metrics.items() if cells.get(k) is None or cell in cells[k]}


def load_metrics(root: Path) -> dict:
    """name -> module of every metrics/<name>.py."""
    return {p.stem: load_module(p, f"proofbench_metric_{p.stem.replace('.', '_')}")
            for p in sorted((root / "metrics").glob("*.py")) if not p.stem.startswith("_")}


def population(cell: dict, seed: int, device) -> Population:
    cfg, mix = cell["config"], cell["mix"]
    p = cfg["accounts"]
    return make_population(seed, accounts=p, virtual=cfg["virtual_accounts"],
                           max_nodes=cfg["bucket"]["max_nodes"],
                           node_len=cfg["bucket"]["node_len"],
                           tampered=math.ceil(mix["tampered_share"] * p), device=device)


def to_host(pop: Population) -> Population:
    return Population(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                         for k, v in vars(pop).items()})


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def quarters(lat: list) -> str:
    """The median request ms of each quarter of the window: whether a slow
    run was slow throughout or in a stretch."""
    q = max(len(lat) // 4, 1)
    meds = [statistics.median(lat[k:k + q]) for k in range(0, len(lat), q)][:4]
    return "request ms median by quarter " + ", ".join(f"{m:.4f}" for m in meds)


def install(entry: str, fn):
    """Put fn in the port's place at ops.mpt.<entry>; returns the undo."""
    from zk_state_proofs_tpu_torch.ops import mpt

    old = getattr(mpt, entry)
    setattr(mpt, entry, fn)
    return lambda: setattr(mpt, entry, old)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: Path = ROOT, control: bool = False, patch=None, t_start=None) -> dict:
    """One run; returns the result line's object. `control` puts the
    reference with its hash checks off in the program's place; `patch`
    (entry name -> wrapper of the port's function) breaks the timed path
    for the fault tests."""
    t0 = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = load_cell(root, name)
    drv_mod = load_module(root / "drivers" / f"{cell['mix']['driver']}.py",
                          f"proofbench_driver_{cell['mix']['driver']}")
    undo = []
    if control:
        from proofbench.drivers._control import STAND_INS
        undo.append(install(drv_mod.ENTRY, STAND_INS[drv_mod.ENTRY]))
    if patch is not None:
        from zk_state_proofs_tpu_torch.ops import mpt
        undo.append(install(drv_mod.ENTRY, patch(getattr(mpt, drv_mod.ENTRY))))
    try:
        return _run(cell, drv_mod, seed, seconds, trace, dev, root, t0)
    finally:
        for u in reversed(undo):
            u()


def _run(cell, drv_mod, seed, seconds, trace, dev, root, t0) -> dict:
    tp = time.perf_counter()
    pop = to_host(population(cell, seed, dev))
    log(f"population: {pop.size} proofs, {pop.nodes.shape[0]} nodes, proof lengths "
        f"{pop.depth_hist}, made in {time.perf_counter() - tp:.3f} s "
        f"({tp - t0:.3f} s after the process started)")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver = drv_mod.Driver(cell, pop, dev)
    td = time.perf_counter()
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s, of which the driver's (packing, upload, warm-up) "
        f"{time.perf_counter() - td:.3f} s")

    stretch = None
    if trace:
        from proofbench.trace import Stretch
        stretch = Stretch(f"{cell['name']}.{seed}", cuda=dev.type == "cuda")
        stretch.warm_up(lambda: driver.request(0))
        if hasattr(driver, "time_packing"):
            driver.time_packing()
    # the set-up's objects (the traffic's entries and node bytes) out of the
    # collector's way: a full collection over them inside the window would
    # be the benchmark's own pause
    gc.collect()
    gc.freeze()
    rng = random.Random(seed)
    kept, seen = [], 0
    lat = []  # each request's ms by the host clock, from its start to its answers on the host
    done = []  # each request's proofs answered
    proofs = attempted = failed = 0
    errors = []
    i = 0
    tw0 = time.perf_counter()
    deadline = tw0 + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if stretch is not None:
            if stretch.t0 is None and now >= tw0 + TRACE_FROM * seconds:
                stretch.start()
            elif (stretch.t0 is not None and stretch.t1 is None
                  and now >= stretch.t0 + TRACE_SECONDS
                  and len(stretch.requests) >= TRACE_MIN_REQUESTS):
                stretch.stop()
        t_req = time.perf_counter()
        attempted += 1
        try:
            n, res = driver.request(i)
        except Exception as exc:  # a request that fails counts, and the run goes on
            failed += 1
            errors.append(repr(exc))
            n, res = 0, None
        lat.append((time.perf_counter() - t_req) * 1e3)
        done.append(n)
        if stretch is not None and stretch.t0 is not None and stretch.t1 is None:
            stretch.requests.append(i)
        proofs += n
        if res is not None:
            seen += 1
            if driver.keep_all or len(kept) < KEEP:
                kept.append((i, res))
            else:
                k = rng.randrange(seen)
                if k < KEEP:
                    kept[k] = (i, res)
        i += 1
    tw1 = time.perf_counter()
    gc.unfreeze()
    if stretch is not None and stretch.t0 is not None and stretch.t1 is None:
        stretch.stop()
    window_s = tw1 - tw0
    if lat:
        log(quarters(lat))
    for span, vals in driver.spans().items():
        if vals:
            log(f"{span} median {statistics.median(vals):.4f} over {len(vals)} requests")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if errors:
        log(f"{failed} requests failed; the first: {errors[0]}")

    metrics = {}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    breakdown = None
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        metrics = {
            "setup_s": {"value": setup_s, "unit": "s"},
            "proofs_per_s": {"value": proofs / window_s, "unit": "proofs/s"},
            "request_ms_p95": {"value": percentile(lat, 95), "unit": "ms"},
            "device_peak_mib": {"value": peak / 2**20, "unit": "MiB"},
        }
        log(f"window {window_s:.3f} s: {attempted} requests, {proofs} proofs, request ms "
            f"median {statistics.median(lat):.4f} p95 {percentile(lat, 95):.4f}")
    elif stretch is not None and stretch.t1 is not None:
        from proofbench.trace import load_groups
        reading = stretch.read(load_groups(root))
        reading.work = [driver.work(j) for j in reading.request_ids]
        reading.spans = driver.spans()
        reading.untraced = untraced(stretch, lat, done, tw0, tw1)
        log(reading.cross_check())
        for mname, mod in load_metrics(root).items():
            v = mod.read(reading)
            if v is not None:
                metrics[mname] = {"value": v, "unit": mod.UNIT}
        dev_info["busy_s"] = reading.busy_s
        dev_info["window_s"] = reading.window_s
        breakdown = reading.breakdown()
        log(f"traced stretch: {reading.requests} requests, {reading.window_s:.4f} s, device "
            f"busy {reading.busy_s:.6f} s, {reading.launch_calls} launch calls")

    metrics = reported(metrics, declared(root), cell["name"])

    # the comparison, once the program's state is freed
    driver.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    checks = {name: {"value": v, "max": lim}
              for name, (v, lim) in driver.check(kept, dev).items()}
    checks["failed_requests"] = {"value": failed, "max": 0}
    checks["checked_requests"] = {"value": len(kept), "min": 1}
    log(f"reference check {time.perf_counter() - tc:.3f} s over {len(kept)} requests")
    ok = all(c["value"] <= c["max"] for c in checks.values() if "max" in c)
    ok = ok and all(c["value"] >= c["min"] for c in checks.values() if "min" in c)
    result["correct"] = bool(ok)
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def untraced(stretch, lat: list, done: list, tw0: float, tw1: float) -> dict:
    """The traced run's window with its profiled stretch left out: the
    stretch's requests, and its wall time from the profiler's start to its
    stop. What a per-layer metric reads for an end-to-end metric that its
    cell does not report."""
    traced = set(stretch.requests)
    seconds = (tw1 - tw0) - (min(stretch.w1, tw1) - stretch.w0)
    return {"lat_ms": [v for j, v in enumerate(lat) if j not in traced],
            "proofs": sum(n for j, n in enumerate(done) if j not in traced),
            "seconds": seconds}


def banned_modules() -> list:
    """Top-level names of loaded modules that this process must not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))
