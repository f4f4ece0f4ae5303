"""The harness on the CPU at a small size: every cell agrees with the
reference through the port's CPU paths; the control and each fault of the
timed path come out not correct; a configuration, mix, cell and metric
added as files are found and run by name."""

import filecmp
import json
from pathlib import Path

import pytest
import torch

from proofbench import harness
from proofbench.tests._small import SRC, cells, small_copy

BENCH = json.loads((SRC.parent / "BENCHMARK.json").read_text())

SEED = 2**33 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("pb"))


def _declared(cell, kind):
    """The BENCHMARK.json metrics of a kind that the cell reports."""
    return {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])}


def _run(root, cell, **kw):
    return harness.run_cell(cell, kw.pop("seed", SEED), kw.pop("seconds", 0.3),
                            kw.pop("trace", False), device="cpu", root=root, **kw)


@pytest.mark.parametrize("cell", cells())
def test_cell_is_correct_on_the_cpu(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == _declared(cell, "end_to_end")
    assert list(r)[-1] == "checks"


# per-layer metrics that the CPU can read: no kernel records, no device time
ON_THE_CPU = {"pack_ms", "table_build_ms", "sweep_ms_p95", "window_proofs_per_s"}


@pytest.mark.parametrize("cell", cells())
def test_traced_run_reports_the_cells_per_layer_metrics(root, cell, monkeypatch):
    # a request takes up to seconds on a busy CPU: a window of a few, and a
    # stretch of one request, so that the stretch starts and ends inside it
    monkeypatch.setattr(harness, "TRACE_MIN_REQUESTS", 1)
    r = _run(root, cell, trace=True, seconds=6.0)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == _declared(cell, "per_layer") & ON_THE_CPU
    assert all(m["value"] > 0 for m in r["metrics"].values()), r["metrics"]


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(root, cell):
    r = _run(root, cell, control=True)
    assert not r["correct"], r["checks"]


def _unchanged(fn):
    def f(*a, **k):
        s, v, n = fn(*a, **k)
        return torch.zeros_like(s), torch.zeros_like(v), torch.zeros_like(n)
    return f


def _half(fn):
    """The first half of the batch verified, the rest left out."""
    def f(nodes, node_lens, num_nodes, *rest, **k):
        h = nodes.shape[0] // 2
        k.pop("depth_segments", None)
        s, v, n = fn(nodes, node_lens, num_nodes, *rest, **k)
        s, v, n = s.clone(), v.clone(), n.clone()
        s[h:], v[h:], n[h:] = 0, 0, 0
        return s, v, n
    return f


def _status_altered(fn):
    def f(*a, **k):
        s, v, n = fn(*a, **k)
        s = s.clone()
        s[0] = 2 if int(s[0]) == 1 else 1
        return s, v, n
    return f


def _value_altered(fn):
    def f(*a, **k):
        s, v, n = fn(*a, **k)
        v = v.clone()
        at = int((n > 0).to(torch.int64).argmax())
        v[at, 0] ^= 1
        return s, v, n
    return f


FAULTS = {"unchanged": _unchanged, "half": _half, "status": _status_altered,
          "value": _value_altered}


# a sweep returns counts, not values: no value to alter there
@pytest.mark.parametrize("cell,fault", [(c, f) for c in cells() for f in sorted(FAULTS)
                                        if not (f == "value" and c.startswith("state_snapshot"))])
def test_fault_is_not_correct(root, cell, fault):
    r = _run(root, cell, patch=FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_added_files_are_found_by_name(tmp_path):
    root = small_copy(tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "mainnet_accounts.json").read_text())
    cfg.update(name="tiny_accounts", accounts=256, batch=64)
    (root / "configs" / "tiny_accounts.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"driver": "pooled", "rotation": 2, "hints": "pack", "segments": False,
         "tampered_share": 0.0625}))
    (root / "workloads" / "tiny_accounts.tiny_mix.json").write_text(json.dumps(
        {"name": "tiny_accounts.tiny_mix", "config": "tiny_accounts", "traffic": "tiny_mix",
         "chips": 1, "why": "a throwaway cell"}))
    (root / "metrics" / "requests_traced.py").write_text(
        'UNIT = "requests"\n\n\ndef read(t):\n    return float(t.requests) or None\n')
    r = _run(root, "tiny_accounts.tiny_mix", trace=True, seconds=0.6)
    assert r["correct"], r["checks"]
    assert r["metrics"]["requests_traced"]["value"] >= 1
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def test_small_copy_leaves_code_alone(tmp_path):
    root = small_copy(tmp_path)
    for p in SRC.rglob("*.py"):
        rel = p.relative_to(SRC)
        if rel.parts[0] != "tests" and "__pycache__" not in rel.parts:
            assert filecmp.cmp(p, root / rel, shallow=False), rel


@pytest.mark.cuda
def test_cached_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell("mainnet_accounts.cached", SEED, 1.0, False, device="cuda")
    assert r["correct"], r["checks"]
