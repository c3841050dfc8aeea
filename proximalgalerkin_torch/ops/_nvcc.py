"""Build of the port's CUDA sources.

Each csrc/<name>.cu has a plain C interface. It is compiled by nvcc for
sm_90a into csrc/build/lib<name>.so (gitignored) at first use, when the
library is missing or older than its source, and loaded with ctypes by
the module that wraps it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def library(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built (set CUDA_HOME)")
    return found


def build(name: str, force: bool = False) -> str:
    """Compile csrc/<name>.cu into csrc/build/lib<name>.so when the
    library is missing, older than the source, or force is set. Returns
    nvcc's report (registers and shared memory, from -Xptxas -v)."""
    src, so = CSRC / f"{name}.cu", library(name)
    if (not force and so.exists()
            and so.stat().st_mtime >= src.stat().st_mtime):
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.{os.getpid()}.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):"
                           f"\n{proc.stderr}")
    tmp.replace(so)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it (the caller declares
    argtypes and keeps the handle)."""
    build(name)
    return ctypes.CDLL(str(library(name)))


def require_cuda(*ts: torch.Tensor):
    """A kernel entry point refuses tensors that are not on a CUDA device."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel call needs CUDA tensors, got {t.device}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream
