"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``.  The libraries go under ``kernels/.build/<hash>/``, keyed by a
hash of every source in ``csrc/`` and the nvcc flags, so an edited source
builds anew.  :func:`build_all` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import time: a machine without ``nvcc`` imports
the package and runs the plain PyTorch versions on CPU tensors.

A missing ``nvcc`` or a failed build raises.  Every C entry point returns
``cudaGetLastError()`` and :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
KERNELS = ("topk_search", "ivf_scan", "homology_score")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are c_void_p, sizes c_int
SIGNATURES = {
    "topk_search": {
        "has_topk_search": [_P] * 7 + [_I] * 5 + [_P],
        "has_topk_merge": [_P] * 3 + [_I] * 3 + [_P] * 4,
        "has_topk_rows_per_block": [],
    },
    "ivf_scan": {
        "has_ivf_scan": [_P] * 7 + [_I] * 6 + [_P],
        "has_ivf_merge": [_P] * 3 + [_I] * 3 + [_P] * 4,
    },
    "homology_score": {
        "has_homology_score": [_P] * 7 + [_I] * 3 + [_P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # nvcc's output (ptxas -v) per kernel


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every missing ``lib<name>.so`` in parallel; return paths."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])    # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def ptr(t: torch.Tensor | None):
    """Device pointer of a contiguous tensor (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_operands(what: str, *tensors: torch.Tensor | None) -> torch.device:
    """All given tensors on one device and contiguous, or raise."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    return dev
