"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources are compiled with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library lands in a directory beside the package, keyed
on a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads at once. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelLibrary:
    """The loaded library, with what its build printed."""

    def __init__(self, lib, path: Path, build_seconds: float, build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log


_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, hdrs = _sources()
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib) -> None:
    lib.zkp_keccak256_rows.restype = ctypes.c_int
    lib.zkp_keccak256_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.zkp_mpt_walk.restype = ctypes.c_int
    lib.zkp_mpt_walk.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.zkp_walk_args_size.restype = ctypes.c_int
    lib.zkp_walk_args_size.argtypes = []


def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _loaded
    if _loaded is not None:
        return _loaded
    out_dir = BUILD_DIR / _digest()
    so = out_dir / "libzkp_kernels.so"
    log = ""
    t0 = time.time()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libzkp_kernels.{os.getpid()}.tmp.so"
        srcs, _ = _sources()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
            capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _loaded = KernelLibrary(lib, so, time.time() - t0, log)
    return _loaded


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
