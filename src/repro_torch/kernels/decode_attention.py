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

On a CUDA tensor it launches the kernel of ``csrc/decode_attention.cu``
(one block per (chunk of S, KV head, batch row), then a combine over the
chunks) and raises if that fails; on a CPU tensor it runs
:func:`decode_attention_plain`.  ``decode_attention.launches`` counts the
kernel's launches (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE = 32              # positions per staged tile; chunks are multiples
MIN_CHUNK = 2 * TILE
BLOCKS_PER_SM = 4      # chunk the sequence until about this many blocks
MAX_GROUP = 32         # query heads per KV head
MAX_D = 256


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


def _chunking(rows: int, n: int, n_sm: int) -> tuple[int, int]:
    """(chunk, n_chunks) covering ``n`` positions for ``rows`` = B * Hkv
    blocks per chunk index: chunks of at least MIN_CHUNK positions, a
    multiple of TILE, and about BLOCKS_PER_SM blocks per SM in all."""
    want = _cdiv(BLOCKS_PER_SM * n_sm, rows)
    chunk = max(MIN_CHUNK, _cdiv(_cdiv(n, want), TILE) * TILE)
    return chunk, _cdiv(n, chunk)


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
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: operands must be 16-byte "
                             "aligned")
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dim() != 0 or cache_len.device != dev or \
                cache_len.is_floating_point():
            raise ValueError("decode_attention: cache_len must be a host int "
                             "or a 0-d integer tensor on the operands' "
                             "device")
        len_t, len_host, covered = cache_len.to(torch.int32), 0, s
    else:
        len_t, len_host = None, int(cache_len)
        covered = min(max(len_host + 1, 0), s)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    if covered == 0 or b == 0:
        return out.zero_()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, nc = _chunking(b * hkv, covered, n_sm)
    part_m = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, nc, d), dtype=torch.float32, device=dev)
    gmax = 1 << (g - 1).bit_length()
    lib = _build.library("decode_attention")
    _build.check(lib.has_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(len_t), len_host, _build.ptr(part_m), _build.ptr(part_l),
        _build.ptr(part_acc), _build.ptr(out), b, h, hkv, s, d, chunk, nc,
        d ** -0.5, gmax, int(dt == torch.bfloat16), _build.stream(dev)),
        "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
