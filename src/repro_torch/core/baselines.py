"""Baseline retrieval-acceleration methods the paper compares against (§IV-A).

Reuse-based:
  Proximity  [Bergman+ '25]  — reuse the cached result whose query embedding
      has cosine similarity > theta with the incoming query.
  SafeRadius [Frieder+ '24]  — reuse iff the incoming query lies inside the
      cached query's 'safe' hyperball; on the unit sphere: reuse iff
      ||q - q_h|| < alpha * margin(q_h), where margin(q_h) = s_1(q_h) -
      s_k(q_h), the cached query's top-1/top-k score gap.
  MinCache   [Haqiq+ '25]    — hierarchical: lexical resemblance via MinHash
      Jaccard over query token sets (threshold t_lex), then embedding cosine
      (threshold t_sem); reuse when either tier matches.

Validation-based:
  CRAGEvaluator [Yan+ '24]   — an LLM judges each draft document's relevance;
      simulated with the oracle golden-document labels + a configurable
      error rate and a per-call latency (0.7 s in the paper's measurement).

ANNS substitutes:
  IVF (retrieval/ivf.py) with scope presets, and a ScaNN substitute =
  int8-quantized scoring + exact re-rank (retrieval/flat.quantized_search).

The reuse state lives in tensors on one device and ``reuse_insert``
updates it in place.  Each match takes the FIRST maximal row, as
``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import as_f32, as_i32, first_argmax, resolve_device


# ---------------------------------------------------------------------------
# Shared reuse-cache state (query embedding -> cached result set)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReuseState:
    query_emb: torch.Tensor      # [H, d] f32
    doc_ids: torch.Tensor        # [H, k] int32
    doc_vecs: torch.Tensor       # [H, k, d] f32
    margins: torch.Tensor        # [H] top1-topk score gap (SafeRadius)
    minhash: torch.Tensor        # [H, n_hash] int32 (MinCache)
    valid: torch.Tensor          # [H] bool
    ptr: torch.Tensor            # scalar int32

    @property
    def device(self) -> torch.device:
        return self.query_emb.device


def init_reuse_state(h_max: int, k: int, d: int, n_hash: int = 64,
                     device=None) -> ReuseState:
    """Empty reuse cache on ``device`` (CUDA unless asked)."""
    dev = resolve_device(device)
    return ReuseState(
        query_emb=torch.zeros((h_max, d), device=dev),
        doc_ids=torch.full((h_max, k), -1, dtype=torch.int32, device=dev),
        doc_vecs=torch.zeros((h_max, k, d), device=dev),
        margins=torch.zeros((h_max,), device=dev),
        minhash=torch.full((h_max, n_hash), 2**31 - 1, dtype=torch.int32,
                           device=dev),
        valid=torch.zeros((h_max,), dtype=torch.bool, device=dev),
        ptr=torch.zeros((), dtype=torch.int32, device=dev),
    )


def reuse_insert(state: ReuseState, q_emb, doc_ids, doc_vecs, scores,
                 mh) -> ReuseState:
    """Write one full result into the ring slot ``ptr % H``, in place."""
    dev = state.device
    scores = as_f32(scores, dev)
    slot = int(state.ptr) % state.valid.shape[0]
    state.query_emb[slot] = as_f32(q_emb, dev)
    state.doc_ids[slot] = as_i32(doc_ids, dev)
    state.doc_vecs[slot] = as_f32(doc_vecs, dev)
    state.margins[slot] = scores[0] - scores[-1]
    state.minhash[slot] = as_i32(mh, dev)
    state.valid[slot] = True
    state.ptr += 1
    return state


# ---------------------------------------------------------------------------
# Matching rules: each -> (ok, slot int32, score), 0-d tensors
# ---------------------------------------------------------------------------

def _pick(ok, score):
    h = first_argmax(score)
    return ok[h], h.to(torch.int32), score[h]


def proximity_match(state: ReuseState, q_emb, theta: float):
    """Cosine-similarity reuse (embeddings are unit-norm)."""
    sims = state.query_emb @ as_f32(q_emb, state.device)
    sims = torch.where(state.valid, sims, -torch.inf)
    h = first_argmax(sims)
    return sims[h] > theta, h.to(torch.int32), sims[h]


def saferadius_match(state: ReuseState, q_emb, alpha: float):
    """Safe-hyperball reuse: ||q - q_h|| < alpha * margin(q_h)."""
    q = as_f32(q_emb, state.device)
    dist = torch.linalg.vector_norm(state.query_emb - q[None, :], dim=-1)
    ok = (dist < alpha * state.margins) & state.valid
    ok_h, h, score = _pick(ok, torch.where(ok, -dist, -torch.inf))
    return ok_h, h, -score


def minhash_signature(tokens: np.ndarray, n_hash: int = 64,
                      seed: int = 0) -> np.ndarray:
    """MinHash over a token-id set (host-side, lexical tier of MinCache)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 2**31 - 1, n_hash, dtype=np.int64)
    b = rng.integers(0, 2**31 - 1, n_hash, dtype=np.int64)
    p = np.int64(2**31 - 1)
    t = tokens.astype(np.int64)[:, None]
    hashes = (a[None, :] * t + b[None, :]) % p                # [T, n_hash]
    return hashes.min(axis=0).astype(np.int32)


def mincache_match(state: ReuseState, q_emb, mh, t_lex: float,
                   t_sem: float):
    """Hierarchical: MinHash-Jaccard tier OR embedding-cosine tier."""
    dev = state.device
    jac = (state.minhash == as_i32(mh, dev)[None, :]).to(
        torch.float32).mean(dim=1)
    sims = state.query_emb @ as_f32(q_emb, dev)
    ok = ((jac > t_lex) | (sims > t_sem)) & state.valid
    return _pick(ok, torch.where(ok, torch.maximum(jac, sims), -torch.inf))


# ---------------------------------------------------------------------------
# CRAG-style LLM evaluator (simulated)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CRAGEvaluator:
    """LLM relevance judge for draft documents.

    The judgement is simulated per document from the synthetic world's
    oracle with asymmetric error rates — LLM judges are conservative
    (high false-negative on relevant docs, near-zero false-positive), and
    markedly weaker on out-of-distribution data (the paper's PopQA
    observation).  The cost model charges the paper's measured ~0.7 s
    inference latency per query.
    """
    fn_rate: float = 0.5           # misses a truly relevant doc
    fp_rate: float = 0.01          # accepts an irrelevant doc
    ood_fn_rate: float = 0.8       # weaker confidence on OOD data (PopQA)
    latency_s: float = 0.7

    def evaluate(self, rng: np.random.Generator, golden_mask: np.ndarray,
                 ood: bool = False) -> bool:
        """Accept the draft iff >=1 doc is judged relevant."""
        fn = self.ood_fn_rate if ood else self.fn_rate
        u = rng.random(golden_mask.shape)
        judged = np.where(golden_mask, u > fn, u < self.fp_rate)
        return bool(judged.any())
