"""Run one cell of the benchmark once, on the CUDA card it is started on.

    python3 -m proofbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints diagnostics on stderr, ending with each
number the correctness check compared beside its limit, and one JSON object
as the last line of stdout. Exits 1 without printing a result where there
is no CUDA card (or fewer than the cell asks for), where the system under
test cannot be imported, or where the process holds JAX or the JAX package
once the window has closed. `--control 1` puts the reference with its hash
checks off in the program's place: that run has to come out not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def card_line() -> str:
    """nvidia-smi's name and power limit of the card (a card set below its
    maximum runs slower under load)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "2")  # before torch starts a thread
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    from proofbench import harness

    cell = harness.load_json(harness.ROOT, "workloads", args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: torch.cuda.is_available() is false")
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"the cell asks for {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} are here")
        return 1
    try:
        import zk_state_proofs_tpu_torch  # noqa: F401
    except ImportError as exc:
        harness.log(f"the system under test cannot be imported: {exc}")
        return 1
    torch.set_num_threads(2)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              control=bool(args.control), t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        harness.log(f"this process holds {banned}: the benchmark may not load them")
        return 1
    harness.log(f"card: {card_line()}")
    for name, c in result["checks"].items():
        lim = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        harness.log(f"check {name} {c['value']} ({lim})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
