"""Kernel K1: batched Keccak-256 on the card (csrc/keccak.cu).

Replaces `zk_state_proofs_tpu.ops.keccak_pallas._keccak_kernel` (entered
there through `keccak256_tpu`). One thread hashes one message from its raw
row bytes and length, padding inside the kernel; see the source for what
bounds it. `keccak256_cuda` dispatches on the tensor's device: a CPU tensor
takes the plain version (`ops.keccak.keccak256`), a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import keccak
from ._build import check_launch, load_library

LAUNCHES = {"keccak256": 0}


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
    lib = load_library().lib
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = lib.zkp_keccak256_rows(rows.data_ptr(), rows.stride(0), rows.shape[1],
                                lens.data_ptr(), u, out.data_ptr(), stream)
    check_launch(rc, "keccak256 kernel")
    LAUNCHES["keccak256"] += 1
    return out
