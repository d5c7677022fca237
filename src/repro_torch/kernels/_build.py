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
import functools
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
KERNELS = ("topk_search", "ivf_scan", "homology_score", "lexical_score",
           "fused_rerank", "decode_attention", "embedding_bag", "cache_fold")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p, sizes c_int,
# scalars c_float
SIGNATURES = {
    "topk_search": {
        "has_topk_search": [_P] * 9 + [_I] * 6 + [_P],
        "has_topk_search_smem": [_I] * 2,
    },
    "ivf_scan": {
        "has_ivf_scan": [_P] * 11 + [_I] * 8 + [_P],
    },
    "homology_score": {
        "has_homology_score": [_P] * 11 + [_I] * 4 + [_P],
        "has_homology_rows_per_cta": [],
    },
    "lexical_score": {
        "has_lexical_score": [_P] * 8 + [_I] * 7 + [_P],
        "has_lexical_smem": [_I],
    },
    "fused_rerank": {
        "has_fused_rerank": [_P] * 7 + [_I] * 5 + [_F, _I, _F, _P],
        "has_fused_rerank_smem": [_I] * 2,
    },
    "decode_attention": {
        "has_decode_attention": [_P] * 4 + [_I] * 2 + [_P] * 4 + [_I] * 9
                                + [_F, _I, _I, _P],
        "has_decode_attention_smem": [_I] * 4,
    },
    "embedding_bag": {
        "has_embedding_bag": [_P] * 4 + [_I] * 3 + [_F, _I, _I, _P],
    },
    "cache_fold": {
        "has_cache_fold": [_P] * 16 + [_I] * 9 + [_P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}
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


def entry(name: str, fn: str):
    """Kernel library ``name``'s C function ``fn``, looked up once."""
    f = _entries.get((name, fn))
    if f is None:
        f = _entries[(name, fn)] = getattr(library(name), fn)
    return f


def build_variants(name: str, variants: dict[str, tuple[str, list[str]]],
                   out: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build variants of kernel ``name`` for the probes: every (source
    text, extra nvcc flags) at once, each loaded with ``name``'s
    signatures; -> {variant: (CDLL, nvcc's output)}."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for i, (var, (src, flags)) in enumerate(variants.items()):
        cu = out / f"{name}_v{i}.cu"
        cu.write_text(src)
        so = out / f"{name}_v{i}.so"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", str(so),
               str(cu)]
        procs[var] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for var, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({var}):\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[var] = (lib, log)
    return libs


def ptr(t: torch.Tensor | None):
    """Device pointer of a contiguous tensor (None for an absent operand)."""
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# the current stream's handle without building a torch.cuda.Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device: torch.device) -> int:
    """The handle (an int) of PyTorch's current stream on ``device``."""
    if _raw_stream is None or device.index is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _raw_stream(device.index)


# (kernel, device index, stream) -> [buffer, ticket words, other words];
# the ticket words at the front are zero between calls (the kernels that
# take a ticket reset it)
scratch_cache: dict[tuple[str, int, int], list] = {}


def scratch(name: str, dev: torch.device, stream: int, tickets: int,
            words: int) -> tuple[int, int]:
    """Device pointers (tickets, words) into kernel ``name``'s cached
    scratch buffer on (device, stream), grown when a call needs more; the
    other words follow the ticket words.  One buffer per stream, so calls
    on two streams never share one."""
    key = (name, dev.index, stream)
    ent = scratch_cache.get(key)
    if ent is None or ent[1] < tickets or ent[2] < words:
        t = max(tickets, ent[1] if ent else 0)
        w = max(words, ent[2] if ent else 0)
        buf = torch.empty(t + w, dtype=torch.float32, device=dev)
        buf[:t].zero_()
        ent = scratch_cache[key] = [buf, t, w]
    base = ent[0].data_ptr()
    return base, base + 4 * ent[1]


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
