"""BENCHMARK.json against the files it names and the contract's characters;
what the benchmark's modules import."""

import ast
import json
import re
from pathlib import Path

import pytest

from proofbench import harness

SRC = Path(__file__).resolve().parent.parent
REPO = SRC.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    whys = [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
    lines = whys + [c["source"] for c in BENCH["configs"]] + BENCH["command"]
    lines += [m["layer"] for m in BENCH["per_layer"]]
    assert all(_line(s) for s in lines), [s for s in lines if not _line(s)]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_files_match_the_benchmark():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = json.loads((SRC / "workloads" / f"{w['name']}.json").read_text())
        assert cell == w
        assert (SRC / "traffic" / f"{w['traffic']}.json").is_file()
    per_layer = harness.load_metrics(SRC)
    assert set(per_layer) == {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert per_layer[m["name"]].UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_each_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for w in BENCH["workloads"]:
        assert w["name"] in e2e["setup_s"]
        assert any(w["name"] in cells for name, cells in e2e.items() if name != "setup_s")
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"]), w["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(SRC).as_posix()
                                        for p in SRC.rglob("*.py")))
def test_imports(path):
    tops = {m.split(".")[0] for m in _imports(SRC / path)}
    assert not tops & {"jax", "jaxlib", "flax", "zk_state_proofs_tpu"}, tops
    if path.startswith("reference/"):
        assert "zk_state_proofs_tpu_torch" not in tops
        assert tops <= {"torch", "numpy", "__future__", "math", "proofbench"}, tops
