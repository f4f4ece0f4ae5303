"""Kernel K2: the fused MPT walk on the card (csrc/mpt_walk.cu).

Replaces `zk_state_proofs_tpu.ops.mpt_pallas._walk_kernel` in all its
modes: `hinted` (walks with pack-time hints: the account level, the block
tries) and its variants `hinted4`, `hinted1`, `ordered` and `pairskip`
(chosen with `hint_mode`), `bounded` (walks without hints:
`verify_proofs`, `verify_proofs_diagnose` and the storage slot level) and
`exact` (the fallback of all of them).

`walk_lanes` is the kernel's wrapper (a CPU tensor takes the plain version,
`ops.mpt.walk_kernel_plain`); `walk_batch_cuda` and
`walk_batch_cuda_segmented` are the ports of `walk_batch_pallas` and
`walk_batch_pallas_segmented`. When any proof latches the overflow flag in
`hinted` or `bounded` mode, the whole batch is walked again in `exact`, as
on the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import mpt
from ._build import check_launch, load_library

_MODE_CODE = {"exact": 0, "hinted": 1, "bounded": 2, "hinted4": 3,  # WalkArgs.mode
              "hinted1": 4, "ordered": 5, "pairskip": 6}
LAUNCHES = dict.fromkeys(_MODE_CODE, 0)


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


def _word_aligned(nodes):
    """nodes as `hinted1`'s word loads need them: N a multiple of 4 and
    every row 4-byte aligned; else a copy zero-padded to N4 (as
    `walk_batch_pallas` pads). Bytes past N read 0 either way, so the
    results do not change."""
    b, d, n = nodes.shape
    if (n % 4 == 0 and nodes.stride(0) % 4 == 0 and nodes.stride(1) % 4 == 0
            and nodes.data_ptr() % 4 == 0):
        return nodes
    out = torch.zeros((b, d, -(-n // 4) * 4), dtype=nodes.dtype, device=nodes.device)
    out[..., :n] = nodes
    return out


def walk_lanes(mode: str, nodes, node_lens, num_nodes, digests, roots,
               key_nibbles, key_lens, max_value_len: int, max_steps: int,
               hints=None):
    """One K2 launch: every proof walked in `mode` (one of
    `ops.mpt.WALK_MODES`), without a fallback. Inputs and outputs as
    `ops.mpt.walk_kernel_plain`: (out i32 [B, 6], values u8 [B, mvl])."""
    if nodes.device.type == "cpu":
        return mpt.walk_kernel_plain(mode, nodes, node_lens, num_nodes, digests,
                                     roots, key_nibbles, key_lens,
                                     max_value_len, max_steps, hints)
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
    if mode == "hinted1":
        nodes = _word_aligned(nodes)
        n = nodes.shape[2]
    out = torch.empty((b, 6), dtype=torch.int32, device=dev)
    values = torch.empty((b, max_value_len), dtype=torch.uint8, device=dev)
    if b == 0:
        return out, values
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
        b, d, n, kn, max_steps, max_value_len, _MODE_CODE[mode])
    lib = load_library().lib
    if lib.zkp_walk_args_size() != ctypes.sizeof(WalkArgs):
        raise RuntimeError("WalkArgs layout differs between Python and CUDA")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.zkp_mpt_walk(ctypes.byref(args), stream)
    check_launch(rc, f"mpt walk kernel ({mode})")
    LAUNCHES[mode] += 1
    return out, values


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
    'ordered'), the whole batch is walked again in `exact`, so results
    equal `ops.mpt.walk_batch` on every input. Deciding that reads one flag
    back to the host."""
    hint_mode = mpt.check_hint_mode(hint_mode)
    if max_steps is None:
        max_steps = nodes.shape[1] + 6
    mode = "bounded" if hints is None else hint_mode
    args = (nodes, node_lens, num_nodes, digests, roots, key_nibbles, key_lens,
            max_value_len, max_steps)
    out, values = walk_lanes(mode, *args, hints=hints)
    fast_ovf = out[:, 4]
    if bool((fast_ovf != 0).any()):
        out, values = walk_lanes("exact", *args)
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
