"""Kernel K2: the fused MPT walk on the card (csrc/mpt_walk.cu).

Replaces `zk_state_proofs_tpu.ops.mpt_pallas._walk_kernel` in all its
modes: `hinted` (walks with pack-time hints: the account level, the block
tries) and its variants `hinted4`, `hinted1`, `ordered` and `pairskip`
(chosen with `hint_mode`), `bounded` (walks without hints:
`verify_proofs`, `verify_proofs_diagnose` and the storage slot level) and
`exact` (the fallback of all of them).

`walk_lanes` is the kernel's wrapper (a CPU tensor takes the plain version,
`ops.mpt.walk_kernel_plain`): it launches the group-of-lanes-per-proof
kernel, whose design the source describes. `walk_batch_cuda` and
`walk_batch_cuda_segmented` are the ports of `walk_batch_pallas` and
`walk_batch_pallas_segmented`. When any proof latches the overflow flag in
`hinted` or `bounded` mode, the whole batch is walked again in `exact`, as
on the TPU, and the card decides it with no launch of its own
(`rerun_exact`): the first walk carries a fresh tag (`next_tag`) and
stores it into the tag's slot of the device's flag ring where a proof
latched, and the guarded `exact` launch walks only where the slot holds
the tag. The host reads no flag.

Counts: LAUNCHES[mode] counts the walk kernel's launches in each mode,
guarded `exact` launches included. `exact_walked(device)` reads the device
tally of guarded launches that walked (one sync; `reset_counts` zeroes
every count).
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from ..utils.profiling import span
from . import mpt
from ._build import check_launch, launch_counts, load_library

_MODE_CODE = {"exact": 0, "hinted": 1, "bounded": 2, "hinted4": 3,  # WalkArgs.mode
              "hinted1": 4, "ordered": 5, "pairskip": 6}
LAUNCHES = launch_counts(*_MODE_CODE)
_TALLY: dict = {}  # device -> int64 [1]: guarded `exact` launches that walked
# A device's flag ring: slot tag % FLAG_RING holds the last tag whose first
# walk latched there. Up to FLAG_RING first walks may be queued ahead of
# their guarded `exact` launches.
FLAG_RING = 4096
_FLAGS: dict = {}  # device -> int64 [FLAG_RING], zero when made, never zeroed again
_TAGS = itertools.count(1)  # next() is atomic under the interpreter lock
_CHECKED = None  # the KernelLibrary whose WalkArgs layout matched this module's


class WalkArgs(ctypes.Structure):
    """Mirror of `struct WalkArgs` in csrc/mpt_walk.cu."""

    _fields_ = [
        ("nodes", ctypes.c_void_p), ("nodes_s0", ctypes.c_longlong),
        ("nodes_s1", ctypes.c_longlong),
        ("node_lens", ctypes.c_void_p), ("lens_s0", ctypes.c_longlong),
        ("lens_s1", ctypes.c_longlong),
        ("num_nodes", ctypes.c_void_p),
        ("digests", ctypes.c_void_p), ("dig_s0", ctypes.c_longlong),
        ("dig_s1", ctypes.c_longlong),
        ("roots", ctypes.c_void_p), ("roots_s0", ctypes.c_longlong),
        ("knib", ctypes.c_void_p), ("knib_s0", ctypes.c_longlong),
        ("key_lens", ctypes.c_void_p),
        ("hints", ctypes.c_void_p), ("hints_s0", ctypes.c_longlong),
        ("hints_s1", ctypes.c_longlong),
        ("out", ctypes.c_void_p), ("values", ctypes.c_void_p),
        ("batch", ctypes.c_int), ("d", ctypes.c_int), ("n", ctypes.c_int),
        ("kn", ctypes.c_int), ("max_steps", ctypes.c_int),
        ("max_value_len", ctypes.c_int), ("mode", ctypes.c_int),
        ("tally", ctypes.c_void_p), ("flag", ctypes.c_void_p),
        ("tag", ctypes.c_ulonglong),
    ]


def _check(name, t, dtype, shape, device):
    """dtype/shape/device check; the last dim must be contiguous (row
    strides are passed to the kernel, so row slices need no copy)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, nodes on {device}")
    if t.ndim == 1 and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.ndim > 1 and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its last dim")


def _library():
    """The kernel library, its `WalkArgs` layout checked against this
    module's once per loaded library (RuntimeError on a mismatch, before
    any launch)."""
    global _CHECKED
    kl = load_library()
    if kl is not _CHECKED:
        if kl.lib.zkp_walk_args_size() != ctypes.sizeof(WalkArgs):
            raise RuntimeError("WalkArgs layout differs between Python and CUDA")
        _CHECKED = kl
    return kl.lib


def _walk_args(mode, nodes, node_lens, num_nodes, digests, roots, key_nibbles,
               key_lens, max_value_len, max_steps, hints, into=None, tally=None,
               tag=None):
    """Check the inputs and allocate the outputs of one launch: (WalkArgs,
    out, values), or (None, out, values) for an empty batch. `into`: the
    (out, values) of an earlier launch on the same batch, written in
    place; `tally`: a device int64 the launch adds one to when it walks;
    `tag`: the re-run flag's tag (a first walk stores it, an `exact`
    launch walks only where its slot holds it)."""
    if nodes.device.type != "cuda":
        raise ValueError(f"walk_lanes: unsupported device {nodes.device}")
    if mode not in mpt.WALK_MODES:
        raise ValueError(f"walk mode {mode!r} not in {mpt.WALK_MODES}")
    hinted = mode in mpt.HINT_MODES
    if hinted and hints is None:
        raise ValueError(f"{mode} mode needs hints")
    if nodes.dtype != torch.uint8 or nodes.ndim != 3:
        raise ValueError(f"nodes must be u8 [B, D, N], got {nodes.dtype} {tuple(nodes.shape)}")
    b, d, n = nodes.shape
    kn = key_nibbles.shape[1] if key_nibbles.ndim == 2 else -1
    dev = nodes.device
    _check("nodes", nodes, torch.uint8, (b, d, n), dev)
    _check("node_lens", node_lens, torch.int32, (b, d), dev)
    _check("num_nodes", num_nodes, torch.int32, (b,), dev)
    _check("digests", digests, torch.uint8, (b, d, 32), dev)
    _check("roots", roots, torch.uint8, (b, 32), dev)
    _check("key_nibbles", key_nibbles, torch.uint8, (b, kn), dev)
    _check("key_lens", key_lens, torch.int32, (b,), dev)
    if hinted:
        _check("hints", hints, torch.uint8, (b, d, 36), dev)
    if n < 1 or kn < 1 or max_value_len < 0 or max_steps < 0:
        raise ValueError("walk_lanes: empty node or key axis, or negative sizes")
    if into is None:
        out = torch.empty((b, 6), dtype=torch.int32, device=dev)
        values = torch.empty((b, max_value_len), dtype=torch.uint8, device=dev)
    else:
        out, values = into
    if b == 0:
        return None, out, values
    args = WalkArgs(
        nodes.data_ptr(), nodes.stride(0), nodes.stride(1),
        node_lens.data_ptr(), node_lens.stride(0), node_lens.stride(1),
        num_nodes.data_ptr(),
        digests.data_ptr(), digests.stride(0), digests.stride(1),
        roots.data_ptr(), roots.stride(0),
        key_nibbles.data_ptr(), key_nibbles.stride(0),
        key_lens.data_ptr(),
        hints.data_ptr() if hinted else None,
        hints.stride(0) if hinted else 0, hints.stride(1) if hinted else 0,
        out.data_ptr(), values.data_ptr(),
        b, d, n, kn, max_steps, max_value_len, _MODE_CODE[mode],
        None if tally is None else tally.data_ptr(),
        None if tag is None else _flag_slot_ptr(dev, tag), 0 if tag is None else tag)
    return args, out, values


def _launch(mode, *tensors, into=None, tally=None, tag=None):
    """One launch of the walk kernel on walk_lanes' inputs, counted in
    LAUNCHES; (out, values) as walk_lanes returns them."""
    args, out, values = _walk_args(mode, *tensors, into=into, tally=tally, tag=tag)
    if args is None:
        return out, values
    lib = _library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    check_launch(lib.zkp_mpt_walk(ctypes.byref(args), stream), f"mpt walk kernel ({mode})")
    LAUNCHES[mode] += 1
    return out, values


def walk_layout(mode: str, nodes, node_lens, num_nodes, digests, roots,
                key_nibbles, key_lens, max_value_len: int, max_steps: int,
                hints=None):
    """How walk_lanes would hold these proofs in shared memory (CUDA
    tensors): {"staging": "all rows" | "one row at a time" | "device
    memory", "lanes": lanes a proof, "proof_bytes": ..., "block_bytes":
    ...}. Launches nothing."""
    args, _, _ = _walk_args(mode, nodes, node_lens, num_nodes, digests, roots,
                            key_nibbles, key_lens, max_value_len, max_steps, hints)
    if args is None:
        return None
    got = (ctypes.c_int * 4)()
    _library().zkp_walk_layout(ctypes.byref(args), got)
    return {"staging": ("all rows", "one row at a time", "device memory")[got[0]],
            "lanes": got[1], "proof_bytes": got[2], "block_bytes": got[3]}


def walk_lanes(mode: str, nodes, node_lens, num_nodes, digests, roots,
               key_nibbles, key_lens, max_value_len: int, max_steps: int,
               hints=None, tag: int | None = None):
    """One K2 launch: every proof walked in `mode` (one of
    `ops.mpt.WALK_MODES`), without a fallback. Inputs and outputs as
    `ops.mpt.walk_kernel_plain`: (out i32 [B, 6], values u8 [B, mvl]).
    On the card, a `tag` (next_tag(); hinted and bounded modes) makes the
    launch record the batch's re-run flag under it (folded_flag); a CPU
    tensor takes the plain version and records nothing."""
    if nodes.device.type == "cpu":
        return mpt.walk_kernel_plain(mode, nodes, node_lens, num_nodes, digests,
                                     roots, key_nibbles, key_lens,
                                     max_value_len, max_steps, hints)
    if tag is not None and mode == "exact":
        raise ValueError("walk_lanes: a tag records a first (hinted or bounded) walk's flag")
    return _launch(mode, nodes, node_lens, num_nodes, digests, roots, key_nibbles,
                   key_lens, max_value_len, max_steps, hints, tag=tag)


def _card(device) -> torch.device:
    """`device`, with the current card's index where "cuda" names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def exact_tally(device) -> torch.Tensor:
    """The device's int64 [1] tally of guarded `exact` launches that
    walked (created zero on first use)."""
    device = _card(device)
    if device not in _TALLY:
        _TALLY[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _TALLY[device]


def exact_walked(device) -> int:
    """Guarded `exact` launches on `device` that walked, since the last
    reset_counts() (reads the device tally: one sync)."""
    return int(exact_tally(device).item())


def reset_counts() -> None:
    """Zero the launch counts and every device tally (not the flag rings,
    whose slots need no zeroing)."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for t in _TALLY.values():
        t.zero_()


def next_tag() -> int:
    """A fresh tag for one batch's first walk: never reused in this
    process, and never 0, which every slot holds before its first store."""
    return next(_TAGS)


def flag_slot(tag: int) -> int:
    """The slot of the flag ring that a first walk with `tag` writes."""
    return tag % FLAG_RING


def flag_ring(device) -> torch.Tensor:
    """The device's flag ring, int64 [FLAG_RING] (made zero on first
    use, once per device)."""
    device = _card(device)
    if device not in _FLAGS:
        _FLAGS[device] = torch.zeros(FLAG_RING, dtype=torch.int64, device=device)
    return _FLAGS[device]


def _flag_slot_ptr(device, tag: int) -> int:
    return flag_ring(device).data_ptr() + 8 * flag_slot(tag)


def folded_flag(device, tag: int) -> torch.Tensor:
    """The re-run flag that the first walk with `tag` recorded on the card,
    i32 [1]: 1 where any of its proofs latched, as guard_plain of its out.
    Read it before FLAG_RING later first walks have been queued."""
    ring = flag_ring(device)
    return (ring[flag_slot(tag)] == tag).to(torch.int32).reshape(1)


def guard_plain(out):
    """The plain version of the re-run flag: i32 [1], 1 where any proof
    of out (i32 [B, 6]) latched its overflow flag (out[:, 4]), else 0."""
    return (out[:, 4] != 0).any().to(torch.int32).reshape(1)


def rerun_exact(out, values, args, tag: int | None):
    """Walk the batch again in `exact` where any proof latched the
    overflow flag — the counterpart of the TPU path's jax.lax.cond. On the
    card the decision stays there: the first walk recorded its flag under
    `tag` (walk_lanes), and the `exact` launch that follows returns at once
    unless the tag's slot holds it, else overwrites out and values in place
    and adds one to the device tally (exact_tally). A CPU batch tests
    guard_plain on the host. args: walk_lanes' positional inputs. Returns
    (out, values)."""
    if out.shape[0] == 0:
        return out, values
    with span("zkp.walk.rerun"):
        if out.device.type == "cpu":
            return walk_lanes("exact", *args) if bool(guard_plain(out)) else (out, values)
        if tag is None:
            raise ValueError("rerun_exact: a batch on the card needs its first walk's tag")
        return _launch("exact", *args, None, into=(out, values),
                       tally=exact_tally(out.device), tag=tag)


def walk_batch_cuda(nodes, node_lens, num_nodes, digests, roots, key_nibbles,
                    key_lens, max_value_len: int, max_steps: int | None = None,
                    with_reasons: bool = False, hints=None,
                    with_overflow: bool = False, hint_mode: str | None = None):
    """The walk of the verify entry points (port of `walk_batch_pallas`).
    Returns (status i32 [B], values u8 [B, max_value_len], value_lens i32
    [B]); with_reasons appends the INVALID reason, with_overflow the
    per-proof overflow flag of the first (hinted or bounded) walk.

    hints (u8 [B, D, 36]) select the hinted mode `hint_mode` (None is
    'hinted'; one of `ops.mpt.HINT_MODES`), no hints `bounded` mode. If any
    proof latches the overflow flag (wrong hints, an inline-child step in a
    hinted mode, an item past its bound, an out-of-order node in
    'ordered'), the whole batch is walked again in `exact` (rerun_exact,
    decided on the card: two launches in all), so results equal
    `ops.mpt.walk_batch` on every input."""
    hint_mode = mpt.check_hint_mode(hint_mode)
    if max_steps is None:
        max_steps = nodes.shape[1] + 6
    mode = "bounded" if hints is None else hint_mode
    args = (nodes, node_lens, num_nodes, digests, roots, key_nibbles, key_lens,
            max_value_len, max_steps)
    with span("zkp.walk"):
        tag = None if nodes.device.type == "cpu" else next_tag()
        out, values = walk_lanes(mode, *args, hints=hints, tag=tag)
        fast_ovf = out[:, 4].clone() if with_overflow else None
        out, values = rerun_exact(out, values, args, tag)
        status = out[:, 0]
        result = (status, values, torch.where(status == mpt.FOUND, out[:, 3], 0))
    if with_reasons:
        result = result + (out[:, 5],)
    if with_overflow:
        result = result + (fast_ovf,)
    return result


def walk_batch_cuda_segmented(depth_segments, nodes, node_lens, num_nodes,
                              digests, roots, key_nibbles, key_lens,
                              max_value_len: int, max_steps: int | None = None,
                              hints=None, hint_mode: str | None = None):
    """One walk_batch_cuda call per contiguous depth segment ((count, d),
    ...) over the segment's first d node rows. A None max_steps resolves
    once, from the global node axis, so truncation matches the unsegmented
    call. In 'ordered' mode each segment's step rows clip to its own d."""
    if max_steps is None:
        max_steps = nodes.shape[1] + 6
    outs, off = [], 0
    for cnt, dseg in depth_segments:
        sl = slice(off, off + cnt)
        outs.append(walk_batch_cuda(
            nodes[sl, :dseg], node_lens[sl, :dseg], num_nodes[sl],
            digests[sl, :dseg], roots[sl], key_nibbles[sl], key_lens[sl],
            max_value_len, max_steps,
            hints=None if hints is None else hints[sl, :dseg],
            hint_mode=hint_mode))
        off += cnt
    if off != nodes.shape[0]:
        raise ValueError(
            f"depth_segments cover {off} rows, batch has {nodes.shape[0]}")
    return tuple(torch.cat(parts) for parts in zip(*outs))
