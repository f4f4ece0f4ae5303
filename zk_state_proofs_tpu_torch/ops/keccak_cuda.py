"""Kernels K1 and K3: batched Keccak-256 on the card (csrc/keccak.cu).

K1 replaces `zk_state_proofs_tpu.ops.keccak_pallas._keccak_kernel` (entered
there through `keccak256_tpu`). A warp hashes one message from its raw row
bytes and length, padding inside the kernel; see the source for the design
and what bounds it. K3 replaces `_keccak_kernel_raw` (entered through
`keccak256_tpu_raw`): the same digests on K1's warp sponge, with every
rate word read as one aligned little-endian 8-byte load and the padding
applied by masks. As in the JAX package, K3 is not on the verify path.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version (`ops.keccak.keccak256`, `ops.keccak.keccak256_raw`), a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import keccak
from ._build import check_launch, launch_counts, load_library

LAUNCHES = launch_counts("keccak256", "keccak256_raw")


def keccak256_cuda(rows, lens):
    """rows u8 [U, W] (last dim contiguous; any row stride), lens i32 [U]
    -> digests u8 [U, 32] of each row's first lens[i] bytes."""
    if rows.device.type == "cpu":
        return keccak.keccak256(rows, lens)
    if rows.device.type != "cuda":
        raise ValueError(f"keccak256_cuda: unsupported device {rows.device}")
    if rows.dtype != torch.uint8 or rows.ndim != 2:
        raise ValueError(f"rows must be u8 [U, W], got {rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] > 1 and rows.stride(1) != 1:
        raise ValueError("rows must be contiguous along the byte axis")
    if lens.dtype != torch.int32 or lens.shape != (rows.shape[0],):
        raise ValueError(f"lens must be i32 [{rows.shape[0]}], got {lens.dtype} {tuple(lens.shape)}")
    if lens.device != rows.device or not lens.is_contiguous():
        raise ValueError("lens must be contiguous and on the rows' device")
    u = rows.shape[0]
    out = torch.empty((u, 32), dtype=torch.uint8, device=rows.device)
    if u == 0:
        return out
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = load_library().lib.zkp_keccak256_rows(rows.data_ptr(), rows.stride(0),
                                               rows.shape[1], lens.data_ptr(), u,
                                               out.data_ptr(), stream)
    check_launch(rc, "keccak256 kernel")
    LAUNCHES["keccak256"] += 1
    return out


def keccak256_cuda_raw(data, lengths):
    """data u8 [B, L], lengths i32 [B] -> digests u8 [B, 32] of each row's
    first lengths[i] bytes, as `keccak256_cuda` gives them (K3, a warp a
    message). The rows are padded to 8-byte aligned rows of a multiple of 8
    bytes (as keccak256_tpu_raw pads them) where they are not, so that every
    rate word is one aligned load."""
    if data.device.type == "cpu":
        return keccak.keccak256_raw(data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"keccak256_cuda_raw: unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.ndim != 2:
        raise ValueError(f"data must be u8 [B, L], got {data.dtype} {tuple(data.shape)}")
    b, width = data.shape
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be i32 [{b}], got {lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != data.device or not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous and on the data's device")
    out = torch.empty((b, 32), dtype=torch.uint8, device=data.device)
    if b == 0:
        return out
    l8 = -(-width // 8) * 8
    if l8 != width or not data.is_contiguous() or data.data_ptr() % 8:
        rows = torch.zeros((b, max(l8, 8)), dtype=torch.uint8, device=data.device)
        rows[:, :width] = data
    else:
        rows = data
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = load_library().lib.zkp_keccak256_raw(rows.data_ptr(), rows.shape[1] // 4,
                                              width // keccak.RATE + 1,
                                              lengths.data_ptr(), b, out.data_ptr(),
                                              stream)
    check_launch(rc, "keccak256_raw kernel")
    LAUNCHES["keccak256_raw"] += 1
    return out
