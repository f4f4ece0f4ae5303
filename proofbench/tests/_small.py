"""A copy of the benchmark's folder cut to a size the CPU runs in seconds:
512 accounts, batches of 128, 4 of them in rotation, sweeps of 2 epochs;
BENCHMARK.json beside it, as in a checkout."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent


def small_copy(dst: Path) -> Path:
    root = dst / "proofbench"
    shutil.copytree(SRC, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(SRC.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    for c in (root / "configs").glob("*.json"):
        d = json.loads(c.read_text())
        d.update(accounts=512, batch=128)
        c.write_text(json.dumps(d))
    for m in (root / "traffic").glob("*.json"):
        d = json.loads(m.read_text())
        if "rotation" in d:
            d["rotation"] = 4
        if "epochs" in d:
            d["epochs"] = 2
        m.write_text(json.dumps(d))
    return root


def cells() -> list:
    return sorted(p.stem for p in (SRC / "workloads").glob("*.json"))
