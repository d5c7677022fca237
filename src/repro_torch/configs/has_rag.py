"""The paper's own system as one batched step: HaS speculative retrieval.

Twin of ``src/repro/configs/has_rag.py``: batched two-channel speculation
(the cache channel over the edge doc store, the fuzzy channel over an int8
replica of the corpus) + homology validation + the full-database scan for
the batch, over the paper's 49.2M-passage corpus at contriever dim 768.
The reference lowers it on a TPU mesh with the corpus sharded; here it runs
on one card, where ``merge_chunks`` cuts the score rows into chunks as the
reference's corpus shards are cut.  :func:`_bundle` is the cell for
``launch/dryrun.py``, at :data:`MERGE_CHUNKS` (the reference's default is
its mesh's device count), with the variant ``corpus_size`` (the card's
cut); the reference's ``store_dtype`` and ``score_dtype`` (a bf16 corpus
and scan) are left out, as the step scans in f32.

Ties go to the lower index everywhere (``stable_topk``, ``first_argmax``),
as ``lax.top_k`` and ``jnp.argmax`` give them.  The homology scores are
the plain ``core/homology.py`` form, as the reference's step uses its jnp
form: no kernel runs here.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import ArchSpec, LoweringBundle, ShapeSpec
from repro_torch.core.homology import homology_scores_batched
from repro_torch.utils import first_argmax, resolve_device, stable_topk

# the chunk-local top-k's chunks on one card (the reference's default is
# its mesh's device count); divides the padded 49,201,152 rows
MERGE_CHUNKS = 48

# corpus rows whose int8 codes are widened to f32 at once by the fuzzy
# channel (the reference widens the whole replica: 4x its size)
FUZZY_CHUNK = 1 << 20


def _iterative_topk(sc: torch.Tensor, k: int):
    """k rounds of (max, first argmax, mask the winner) over the last dim
    of ``sc`` (left unchanged) -> (vals [..., k], idx [..., k] int32)."""
    sc = sc.clone()
    vals, idx = [], []
    for _ in range(k):
        cur = sc.max(dim=-1).values
        arg = first_argmax(sc)
        sc.scatter_(-1, arg[..., None], -torch.inf)          # mask winner
        vals.append(cur)
        idx.append(arg)
    return torch.stack(vals, dim=-1), torch.stack(idx, dim=-1).int()


def _sharded_topk(scores: torch.Tensor, k: int, merge_chunks: int):
    """Top-k of each row of ``scores [B, N]`` -> (vals [B, k], idx [B, k]
    int32).  ``merge_chunks = C > 0`` (dividing N) takes a chunk-local
    top-k of each of C column chunks with :func:`_iterative_topk` and a
    small merge of the C*k winners; otherwise one stable sort of the whole
    rows.  Both give the same result."""
    b, n = scores.shape
    if not merge_chunks or n % merge_chunks:
        v, i = stable_topk(scores, k)
        return v, i.int()
    loc = n // merge_chunks
    lv, li = _iterative_topk(scores.view(b, merge_chunks, loc), min(k, loc))
    li = li + (torch.arange(merge_chunks, dtype=torch.int32,
                            device=li.device) * loc)[None, :, None]
    v, pos = stable_topk(lv.reshape(b, -1), k)             # tiny merge
    return v, torch.gather(li.reshape(b, -1), 1, pos)


@dataclasses.dataclass(frozen=True)
class HasRagConfig:
    name: str = "has-rag"
    # 49.2M passages padded up to a 256-shard-divisible row count (the
    # reference's input shardings need exact divisibility; pad rows are
    # masked)
    corpus_size: int = 49_201_152
    d: int = 768                 # contriever embedding dim
    k: int = 10
    tau: float = 0.2
    h_max: int = 5000
    doc_cap: int = 50_000
    query_batch: int = 64


def has_retrieval_step(corpus, fuzzy_q, fuzzy_scale, cache_doc_emb,
                       cache_doc_ids, query_doc_ids, query_valid, queries,
                       *, k: int, tau: float, merge_chunks: int = 0):
    """Batched HaS step (Algorithm 1 over a query micro-batch).

    corpus [N,d] f32; fuzzy_q [N,d] int8 with fuzzy_scale [N] (the
    compressed fuzzy channel); cache_doc_emb [Dc,d], cache_doc_ids [Dc]
    (-1: empty slot), query_doc_ids [H,k], query_valid [H]; queries [B,d].
    Returns (ids [B,k] int32, accept [B] bool, homology [B] f32).
    """
    b = queries.shape[0]
    # cache channel: exact top-k over the doc store
    sc = queries @ cache_doc_emb.T                          # [B, Dc]
    sc = torch.where(cache_doc_ids[None, :] >= 0, sc, -torch.inf)
    s_c, slots = stable_topk(sc, k)
    i_c = torch.where(torch.isfinite(s_c), cache_doc_ids[slots], -1).int()

    # fuzzy channel: the int8 replica's scores, widened a row chunk at a
    # time (the products are the reference's (q @ fq^T) * scale)
    n = fuzzy_q.shape[0]
    s_f = torch.empty((b, n), dtype=queries.dtype, device=queries.device)
    for lo in range(0, n, FUZZY_CHUNK):
        hi = min(lo + FUZZY_CHUNK, n)
        s_f[:, lo:hi] = (queries @ fuzzy_q[lo:hi].T.to(queries.dtype)) \
            * fuzzy_scale[None, lo:hi]
    s_f, i_f = _sharded_topk(s_f, k, merge_chunks)

    # merge/rerank -> draft
    dup = (i_f[:, :, None] == i_c[:, None, :]).any(dim=2)
    s_f = torch.where(dup, -torch.inf, s_f)
    s_all = torch.cat([s_c, s_f], dim=1)
    i_all = torch.cat([i_c, i_f], dim=1)
    _, ti = stable_topk(s_all, k)
    draft = torch.gather(i_all, 1, ti)                      # [B, k]

    # homology validation against the query cache
    scores = homology_scores_batched(draft, query_doc_ids, query_valid)
    best = scores.max(dim=1).values
    accept = best > tau

    # fallback: the full-database scan, computed for the whole batch (the
    # serving engine routes only rejected queries here; the step selects)
    s_full = queries @ corpus.T
    _, i_full = _sharded_topk(s_full, k, merge_chunks)
    del s_full
    ids = torch.where(accept[:, None], draft, i_full)
    return ids, accept, best


def _bundle(shape_name: str, corpus_size: int | None = None):
    """The step over ``corpus_size`` rows (default the config's) as
    ``meta`` arguments of the reference's shapes and dtypes."""
    from repro_torch.configs.families import (BOOL, F32, I32, meta,
                                              serving)
    cfg = HasRagConfig()
    if corpus_size is not None:
        cfg = dataclasses.replace(cfg, corpus_size=corpus_size)
    n, d, k, b = cfg.corpus_size, cfg.d, cfg.k, cfg.query_batch
    fn = functools.partial(has_retrieval_step, k=k, tau=cfg.tau,
                           merge_chunks=MERGE_CHUNKS)
    args = (meta((n, d), F32), meta((n, d), torch.int8), meta((n,), F32),
            meta((cfg.doc_cap, d), F32), meta((cfg.doc_cap,), I32),
            meta((cfg.h_max, k), I32), meta((cfg.h_max,), BOOL),
            meta((b, d), F32))
    return LoweringBundle(serving(fn), args)


def quantize_rows(corpus: torch.Tensor):
    """Per-row symmetric int8 codes of ``corpus`` -> (codes [N,d] int8,
    scale [N] f32): ``scale = max|row| / 127`` (a device divisor, IEEE
    division as on the CPU) and ``clip(round(row / scale), -127, 127)``."""
    div = torch.tensor(127.0, device=corpus.device)
    scale = corpus.abs().amax(dim=1) / div
    codes = torch.clamp(torch.round(corpus / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def smoke_args(device=None):
    """The reference's smoke inputs (n=512, d=16, k=4, B=3, H=32, Dc=64;
    numpy ``default_rng(0)``) on ``device`` (default CUDA)."""
    import numpy as np
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, d, k, b, h, dc = 512, 16, 4, 3, 32, 64

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    corpus = t(rng.normal(size=(n, d)), torch.float32)
    fq, scale = quantize_rows(corpus)
    args = (corpus, fq, scale,
            t(rng.normal(size=(dc, d)), torch.float32),
            t(rng.integers(0, n, dc), torch.int32),
            t(rng.integers(0, n, (h, k)), torch.int32),
            torch.ones(h, dtype=torch.bool, device=dev),
            t(rng.normal(size=(b, d)), torch.float32))
    return HasRagConfig(corpus_size=n, d=d, k=k), args


def _smoke(device=None):
    """-> ``(cfg, fn, args)``: the reduced step and its inputs."""
    cfg, args = smoke_args(device)
    fn = functools.partial(has_retrieval_step, k=cfg.k, tau=0.2)
    return cfg, fn, args


ArchSpec(
    name="has-rag", family="rag", source="the paper (HaS)",
    shapes={"retrieve_batch": ShapeSpec(
        "retrieve_batch", "retrieval",
        dict(corpus=49_200_000, d=768, query_batch=64, k=10))},
    make_bundle=_bundle,
    make_smoke=_smoke,
    config=HasRagConfig(),
).register()
