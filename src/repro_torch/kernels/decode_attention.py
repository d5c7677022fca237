"""Flash-decoding attention of one query token over a KV cache: kernel + plain.

``decode_attention`` replaces the Pallas kernel
``src/repro/kernels/decode_attention.py::_decode_kernel``.  It takes
``q [B,H,D]`` and ``k_cache``, ``v_cache [B,S,Hkv,D]`` (bf16 or f32, loaded
as f32), where query head ``h`` reads KV head ``h // (H / Hkv)``, and
attends to positions ``<= cache_len`` (a host int or a 0-d integer tensor on
the operands' device), with scores scaled by ``D**-0.5`` and the softmax in
f32.  It returns f32 ``[B,H,D]``.  With ``Hkv == H`` this is the TPU
kernel's signature, whose cache is already head-repeated; the serving path
keeps the cache in its GQA layout.

On a CUDA tensor it launches one kernel of ``csrc/decode_attention.cu``
(bf16 with D in 64/128/256: tensor cores over a cp.async ring; otherwise
the SIMT kernel), one CTA per (chunk of S, KV head, batch row), the chunks
merged inside the same launch, and raises if that fails; on a CPU tensor it
runs :func:`decode_attention_plain`.  ``decode_attention.launches`` counts
the kernel's launches (one per call).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

TILE = 64              # positions per pipeline stage of the MMA kernel
CHUNK_ALIGN = 16       # chunks are whole warp steps of 16 positions
CHUNK_OVERHEAD = 2     # a chunk's prologue and merge, in tiles
SINGLE_LEVEL = 16      # up to this many chunks merge in one level
MAX_CHUNKS = 1024      # two levels of at most 32 partials
MAX_GROUP = 32         # query heads per KV head
MAX_D = 256
MMA_D = (64, 128, 256)
SIMT_CTAS_PER_SM = 4   # the SIMT kernel's blocks are small


def _group(q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor) -> int:
    b, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or \
            k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    hkv = k_cache.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"decode_attention: {h} query heads over {hkv} KV "
                         f"heads")
    return h // hkv


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len):
    """Masked softmax attention over the cache (``decode_attention_ref``),
    with GQA by reshape: q [B,H,D], k/v [B,S,Hkv,D] -> f32 [B,H,D]."""
    g = _group(q, k_cache, v_cache)
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bngd,bsnd->bngs", qf, k_cache.float())
    scores = scores * (d ** -0.5)
    pos = torch.arange(s, device=q.device)
    scores = scores.masked_fill(~(pos <= cache_len), -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", probs, v_cache.float())
    return out.reshape(b, h, d)


def uses_mma(dtype: torch.dtype, d: int, g: int) -> bool:
    """Whether the tensor-core kernel takes this shape (bf16, D in MMA_D,
    G <= 32 query heads per KV head, G <= 16 at D = 256)."""
    return (dtype == torch.bfloat16 and d in MMA_D and g <= MAX_GROUP
            and (g <= 16 or d <= 128))


@functools.lru_cache(maxsize=4096)
def plan_chunks(rows: int, covered: int, slots: int) -> tuple[int, int, int]:
    """(chunk, n_chunks, group) for ``rows`` = B * Hkv sequences of
    ``covered`` positions on ``slots`` resident CTAs.

    Chunks are whole CHUNK_ALIGNs; the count minimizes waves x (TILEs per
    chunk + CHUNK_OVERHEAD), fewer chunks on a tie.  The partials of more
    than SINGLE_LEVEL chunks merge in groups of ``group`` (~sqrt), else in
    one level (``group`` = n_chunks)."""
    best = None
    for nc in range(1, min(_cdiv(covered, CHUNK_ALIGN), MAX_CHUNKS) + 1):
        chunk = _cdiv(_cdiv(covered, nc), CHUNK_ALIGN) * CHUNK_ALIGN
        if _cdiv(covered, chunk) != nc:       # the same cut as fewer chunks
            continue
        cost = _cdiv(rows * nc, slots) * (chunk / TILE + CHUNK_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, nc, chunk)
    _, nc, chunk = best
    group = nc if nc <= SINGLE_LEVEL else math.isqrt(nc - 1) + 1
    return chunk, nc, group


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len):
    """Same contract as :func:`decode_attention_plain`; the kernel on CUDA.

    A sequence with no valid position (``cache_len < 0``) gets zeros, as on
    the TPU, where the plain version gives NaN."""
    if q.device.type != "cuda":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    g = _group(q, k_cache, v_cache)
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    dt = k_cache.dtype
    if dt not in (torch.float32, torch.bfloat16) or q.dtype != dt or \
            v_cache.dtype != dt:
        raise ValueError(f"decode_attention: q, k, v must share one dtype of "
                         f"f32 or bf16, got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    vec = 8 if dt == torch.bfloat16 else 4
    if d % vec or d > MAX_D or g > MAX_GROUP:
        raise ValueError(f"decode_attention: D={d} must be a multiple of "
                         f"{vec} and <= {MAX_D}, H/Hkv={g} <= {MAX_GROUP}")
    if b > 65535 or hkv > 65535:
        raise ValueError("decode_attention: B and Hkv <= 65535")
    dev = _build.check_operands("decode_attention", q, k_cache, v_cache)
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("decode_attention: operands must be 16-byte "
                         "aligned")
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dim() != 0 or cache_len.device != dev or \
                cache_len.is_floating_point():
            raise ValueError("decode_attention: cache_len must be a host int "
                             "or a 0-d integer tensor on the operands' "
                             "device")
        if cache_len.dtype not in (torch.int32, torch.int64):
            cache_len = cache_len.to(torch.int32)
        len_t, len_host, covered = cache_len, 0, s
    else:
        len_t, len_host = None, min(int(cache_len), s)
        covered = min(max(len_host + 1, 0), s)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    if covered == 0 or b == 0:
        return out.zero_()
    mma = uses_mma(dt, d, g)
    slots = _build.sm_count(dev) * (1 if mma else SIMT_CTAS_PER_SM)
    chunk, nc, group = plan_chunks(b * hkv, covered, slots)
    stream = _build.stream(dev)
    n_groups = _cdiv(nc, group)
    tstride = 1 + n_groups
    if nc > 1:
        parts = b * hkv * (nc + n_groups) * g
        ml_words = _cdiv(2 * parts, 4) * 4    # acc starts 16-byte aligned
        tix, ml = _build.scratch("decode_attention", dev, stream,
                                 _cdiv(b * hkv * tstride, 4) * 4,
                                 ml_words + parts * d)
        acc = ml + 4 * ml_words
    else:
        tix = ml = acc = None
    lib = _build.library("decode_attention")
    _build.check(lib.has_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(len_t), int(len_t is not None and
                               len_t.dtype == torch.int64), len_host,
        tix, ml, acc, _build.ptr(out), b, h, hkv, s, d, chunk, nc, group,
        tstride, d ** -0.5, int(dt == torch.bfloat16), int(mma), stream),
        "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
