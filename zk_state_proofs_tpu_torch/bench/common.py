"""What the port's benchmark programs share: the card line, JSON lines, the
perturbation counter and the accumulator fold of the JAX package's
bench.py (`bench.py:138-164`), timers on CUDA events, the kernels' launch
counts, and the least time a kernel's work could take (`bound_ms`, one
copy, which `chip_smoke.py` imports).

A timer runs on the card only: it raises on a CPU device and without a
card, so no CPU time is ever printed under a device metric's name. The
witness, step and fold code runs on either device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import keccak, keccak_cuda, mpt, mpt_cuda
from ..utils.profiling import cuda_timer, device_profile, queued_timer
from ..witness_bridge import BATCH_FIELDS, POOL_FIELDS

# The least time a kernel could take (`bound_ms`): the larger of its bytes
# over the memory rate and its operations over the ALU rate.
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
# (Hopper SM; the float32 rate of 67 TFLOP/s counts 128 lanes and FMA as 2).
# Keccak's operations are LOP3 and SHF, which issue only on the integer ALU
# pipe; the FMA pipe's IMAD executes neither, so it does not raise this rate.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# per absorbed rate block, in 32-bit instructions as the card can issue them
# (three-input LOP3, one funnel shift per half of a 64-bit rotate), 24 rounds
# of: theta 80 (each column's 5-way XOR 2 LOP3 per half = 20, rot1 of the 5
# column sums 10 SHF, D folded into one 3-way XOR per lane half = 50); rho
# and pi 48 (24 rotates, none by 0 or 32); chi 50 (b ^ (~c & d) is one LOP3
# per lane half); iota 2. Plus the absorb: 17 lanes x 2 XOR.
KECCAK_OPS_PER_BLOCK = 24 * (80 + 48 + 50 + 2) + 17 * 2
# per walked node, a floor: 18 RLP header decodes of 16 operations each
WALK_OPS_PER_NODE = 18 * 16
RATE = 136  # Keccak-256's rate in bytes: a message of L bytes absorbs L // 136 + 1 blocks
# queued_timer's spin before the queued calls, in clock cycles (about 0.2 s):
# the host must queue every timed call within half of it
SPIN_CYCLES = 400_000_000
# rows of each timed K1 call held against the plain keccak (HashStep)
PLAIN_ROWS = 1024


def log(msg: str) -> None:
    """A diagnostic line on stderr (stdout carries the JSON lines)."""
    print(msg, file=sys.stderr, flush=True)


def emit(**fields) -> dict:
    """Print `fields` as one JSON line on stdout and return them."""
    print(json.dumps(fields), flush=True)
    return fields


def require(cond, msg: str) -> None:
    """Raise RuntimeError(msg) unless cond (survives python -O)."""
    if not cond:
        raise RuntimeError(msg)


def require_card(where="cuda") -> torch.device:
    """The CUDA device of `where` (a device, its name or a tensor). Raises
    RuntimeError without a card, or where `where` is not a CUDA device."""
    dev = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    require(torch.cuda.is_available(),
            "this benchmark needs a CUDA card: torch.cuda.is_available() is false")
    require(dev.type == "cuda", f"a device time cannot come from {dev}")
    return dev


def card_info() -> dict:
    """The card the numbers come from: torch's name of device 0, the device
    count, and nvidia-smi's name and power limit (a card may be set below
    its maximum, and then runs slower under load)."""
    require_card()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": out.stdout.strip().splitlines()[0]}


# ---- the perturbation counter and the accumulator fold ------------------

def perturb(ctr: int, *tables) -> None:
    """Write the counter's low byte into the last byte of every row of each
    table (a node table u8 [B, D, N], a pool u8 [U, N]), as bench.py's step
    does (`bench.py:145-146`). Byte N - 1 is padding in every row of the
    benchmarks' batches, so every call is distinct work and its results do
    not change."""
    for t in tables:
        t[..., -1] = ctr & 0xFF


def value_word(values, lens):
    """One call's per-proof value word: the sum of its value bytes plus its
    length << 8 (i64 [B])."""
    return values.sum(1, dtype=torch.int64) + (lens.to(torch.int64) << 8)


class Fold:
    """bench.py's accumulators (`bench.py:150-160`) on the batch's device,
    folded by addition in int64 (bench.py XORs, which two equal calls
    cancel): acc += status, accv += the value word of every value byte and
    length. `calls` counts the folded calls."""

    def __init__(self, rows: int, device):
        self.acc = torch.zeros(rows, dtype=torch.int64, device=device)
        self.accv = torch.zeros(rows, dtype=torch.int64, device=device)
        self.calls = 0

    def zero(self) -> None:
        self.acc.zero_()
        self.accv.zero_()
        self.calls = 0

    def add(self, status, values, lens) -> None:
        self.acc.add_(status)
        self.accv.add_(values.sum(1, dtype=torch.int64)).add_(lens, alpha=256)
        self.calls += 1

    def check(self, once, what: str) -> None:
        """Read the accumulators (one host read) and raise unless every
        proof was FOUND in every folded call and the value fold equals
        `calls` times `once` (one call's value_word)."""
        acc, accv = self.acc.cpu(), self.accv.cpu()
        require(bool((acc == self.calls * mpt.FOUND).all()),
                f"{what}: {int((acc != self.calls * mpt.FOUND).sum())} proofs were not FOUND "
                f"in each of {self.calls} calls")
        require(torch.equal(accv, self.calls * once.cpu()),
                f"{what}: the values changed under the perturbation")


def pooled_args(t: dict) -> list:
    """verify_proofs_pooled's positional tensors from `t`
    (witness_bridge.packed_to_tensors), with its pool hints where it has
    them."""
    return [t[k] for k in BATCH_FIELDS + POOL_FIELDS] + (
        [t["pool_hints"]] if "pool_hints" in t else [])


def pooled_call(t: dict, **kw):
    """call(ctr) over the tensors `t` (witness_bridge.packed_to_tensors):
    the counter into the last byte of every node and pool row, then
    verify_proofs_pooled(**kw) over pooled_args(t). Returns (status,
    values, value_lens). Counter 0 leaves the rows as packed."""
    args = pooled_args(t)

    def call(ctr):
        perturb(ctr, t["nodes"], t["pool_nodes"])
        return mpt.verify_proofs_pooled(*args, **kw)
    return call


class Step:
    """bench.py's timed step on the port: each call advances the counter,
    runs `call(ctr)` (which perturbs its inputs and returns status, values
    and value lengths) and folds the result. A Step takes (and ignores) the
    iteration index the timers pass."""

    def __init__(self, call, rows: int, device, ctr: int = 0):
        self.call, self.ctr = call, ctr
        self.fold = Fold(rows, device)

    def __call__(self, _i=None) -> None:
        self.ctr += 1
        self.fold.add(*self.call(self.ctr))

    def run(self, k: int) -> Fold:
        for _ in range(k):
            self()
        return self.fold

    def timed(self, timer, iters: int, reps: int, once, what: str) -> list:
        """`reps` runs of timer(self, iters, device) (wall_ms, device_ms),
        the accumulators zeroed before each and checked after it against
        `once` (value_word of an unperturbed call). Returns each run's
        ms."""
        runs = []
        for rep in range(reps):
            self.fold.zero()
            runs.append(timer(self, iters, self.fold.acc.device))
            self.fold.check(once, f"{what} run {rep}")
        return runs


class HashStep:
    """bench.py's K1 step: each call writes the next counter into byte
    `byte` of every row of `rows`, runs fn(rows) (u8 [R, 32] digests) and
    keeps the first PLAIN_ROWS digests. check() holds every kept call's
    digests against the plain keccak of its own rows, in one plain call.
    Takes (and ignores) the iteration index the timers pass."""

    def __init__(self, fn, rows, lens, byte: int):
        self.fn, self.rows, self.lens, self.byte = fn, rows, lens, byte
        self.n = min(PLAIN_ROWS, rows.shape[0])
        self.kept = []

    def __call__(self, _i=None) -> None:
        self.rows[:, self.byte] = (len(self.kept) + 1) & 0xFF
        self.kept.append(self.fn(self.rows)[:self.n].clone())

    def check(self, what: str) -> None:
        """Raise unless every kept call's digests equal the plain keccak's;
        forget them."""
        k = len(self.kept)
        require(k > 0, f"{what}: no call to check")
        sample = self.rows[:self.n].repeat(k, 1)
        sample.view(k, self.n, -1)[:, :, self.byte] = (
            torch.arange(1, k + 1, device=sample.device) & 0xFF).to(torch.uint8)[:, None]
        want = keccak.keccak256(sample, self.lens[:self.n].repeat(k))
        require(torch.equal(torch.cat(self.kept), want),
                f"{what}: a timed call's digests differ from the plain keccak")
        self.kept.clear()


def in_turns(fns: dict, runs: int) -> dict:
    """`runs` timed runs of each fn() (ms), the variants forward in even
    turns and backward in odd ones (A B, B A, ...). Returns every
    variant's runs."""
    out = {v: [] for v in fns}
    for k in range(runs):
        for v in list(fns)[::1 if k % 2 == 0 else -1]:
            out[v].append(fns[v]())
    return out


# ---- timers (the card only) ----------------------------------------------

def wall_ms(fn, iters: int, where) -> float:
    """Mean ms a call of fn(i) over `iters` back-to-back calls, CUDA events
    around them (utils.profiling.cuda_timer): the host's launch cost
    included, what a caller gets."""
    require_card(where)
    return cuda_timer(fn, iters)


def device_ms(fn, iters: int, where) -> float:
    """Mean device ms a call of fn(i) over `iters` calls queued behind a
    spin kernel (utils.profiling.queued_timer): the card's time, its own
    gaps between kernels included. Raises where queueing the calls outran
    the spin (the card may have waited on the host)."""
    require_card(where)
    ms = queued_timer(fn, iters, spin_cycles=SPIN_CYCLES)
    require(ms is not None, f"queueing {iters} calls outran the spin: no device time")
    return ms


def busy_profile(fn, iters: int, where) -> dict:
    """torch.profiler over `iters` calls of fn(i) (utils.profiling.
    device_profile): host ms a call, device busy ms a call, device
    launches a call, the top kernels."""
    require_card(where)
    return device_profile(fn, iters)


# ---- launch counts ---------------------------------------------------------

def zero_counts() -> None:
    """Zero every kernel wrapper's launch count and the device tallies."""
    for k in keccak_cuda.LAUNCHES:
        keccak_cuda.LAUNCHES[k] = 0
    mpt_cuda.reset_counts()


def read_counts(device="cuda") -> dict:
    """Every kernel wrapper's launch count since zero_counts(), and the
    guarded `exact` launches that walked (the device tally, one sync)."""
    return {**keccak_cuda.LAUNCHES, **mpt_cuda.LAUNCHES,
            "exact_walked": mpt_cuda.exact_walked(device)}


# ---- bounds ----------------------------------------------------------------

def seg_offsets(segments):
    """The first row of each ((count, ...), ...) segment."""
    offs, off = [], 0
    for cnt, _ in segments:
        offs.append(off)
        off += cnt
    return offs


def least_time(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def keccak_bound(lens, segments):
    """Bound of hashing rows of these lengths in segments ((count, width),
    ...): each row's first min(len, width) bytes read once, its length
    read, its digest written."""
    nbytes = ops = 0
    for o, (c, w) in zip(seg_offsets(segments), segments):
        ln = lens[o:o + c].to(torch.int64).clamp(min=0)
        nbytes += int(ln.clamp(max=w).sum()) + 36 * c
        ops += int((torch.div(ln, RATE, rounding_mode="floor").clamp(max=w // RATE) + 1).sum())
    return least_time(nbytes, ops * KECCAK_OPS_PER_BLOCK)


def walk_bound(nodes, node_lens, num_nodes, kn, max_value_len, hinted):
    """Bound of walking these proofs: each live node's bytes, length and
    digest (and hints) read once, the root, key and counts read, six words
    and the value written; WALK_OPS_PER_NODE per live node."""
    b, d, n = nodes.shape
    live = torch.arange(d, device=nodes.device)[None] < num_nodes.clamp(0, d)[:, None]
    n_live = int(live.sum())
    nbytes = (int(node_lens.clamp(0, n)[live].sum()) + n_live * (36 + (36 if hinted else 0))
              + b * (32 + kn + 8) + b * (24 + max_value_len))
    return least_time(nbytes, n_live * WALK_OPS_PER_NODE)
