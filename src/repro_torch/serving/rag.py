"""RAG serving: HaS retrieval feeding a transformer generator (paper Fig. 1).

Twin of ``examples/rag_serving.py`` (its request loop, lines 27-98), as a
function over an engine, a generator and its parameters:

1. each query of a batch goes through ``HasEngine.step`` (sequential; the
   cache changes between queries);
2. the first k retrieved ids become context tokens: the prompt is the ids
   mod 4000, each repeated 5 times, left-aligned in ``prompt_len - 8``
   slots (zeros after), then 8 query tokens (:func:`build_prompt`);
3. ``prefill`` gives the first token (TTFT), then ``gen_len`` greedy
   ``decode_step``s run from a FRESH, all-zero KV cache starting at position
   ``prompt_len``, so each step attends over ``prompt_len`` zero keys and
   values plus the generated tokens.  The reference does exactly this (its
   ``prefill`` returns no cache); the port copies it.

Greedy picks go through ``first_argmax`` (ties to the lowest token id, as
``jnp.argmax``).  A prefill of zeros runs first to initialise the card's
matrix libraries, as the reference warms up; the decode loop needs no warm-up
(nothing is compiled), so ``decode_attention`` launches exactly
``n_layers * gen_len`` times per batch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.utils import first_argmax, resolve_device, synchronize

CTX_IDS = 10           # retrieved ids per prompt
QUERY_TOKENS = 8       # prompt tail


@dataclasses.dataclass
class RagResult:
    ids: np.ndarray            # [n, CTX_IDS] retrieved ids per request
    accepts: np.ndarray        # [n] bool, the HaS draft was accepted
    retrieval_s: np.ndarray    # [n] HaS retrieval latency per request
    tokens: np.ndarray         # [n, gen_len + 1] prefill's token, then decode's
    ttft_s: np.ndarray         # [n_batches] prefill time per batch
    decode_tps: np.ndarray     # [n_batches] decoded tokens / s per batch

    def summary(self) -> dict[str, float]:
        return {"requests": int(len(self.accepts)),
                "retrieval_avg_s": float(np.mean(self.retrieval_s)),
                "dar": float(np.mean(self.accepts)),
                "ttft_avg_s": float(np.mean(self.ttft_s)),
                "decode_tps_avg": float(np.mean(self.decode_tps))}


def build_prompt(group, doc_ids, prompt_len: int) -> np.ndarray:
    """[len(group), prompt_len] int64 prompts: doc tokens, then query
    tokens (``examples/rag_serving.py:67-73``)."""
    prompt = np.zeros((len(group), prompt_len), np.int64)
    for i, (q, ids) in enumerate(zip(group, doc_ids)):
        ctx = (np.abs(ids) % 4000).repeat(5)[:prompt_len - QUERY_TOKENS]
        prompt[i, :len(ctx)] = ctx
        prompt[i, -QUERY_TOKENS:] = \
            (q["tokens"] % 4000)[:QUERY_TOKENS].repeat(2)[:QUERY_TOKENS]
    return prompt


def generate(params, cfg: tf.TransformerConfig, prompt: torch.Tensor,
             gen_len: int, backend: str | None = None):
    """Prefill, a fresh cache, ``gen_len`` greedy decode steps.  Returns
    (tokens [B, gen_len + 1] int32, ttft_s, decode tokens per s)."""
    dev = prompt.device
    b, prompt_len = prompt.shape
    synchronize(dev)
    t0 = time.perf_counter()
    logits = tf.prefill(params, prompt, cfg)
    synchronize(dev)
    ttft = time.perf_counter() - t0
    cache = tf.init_kv_cache(cfg, b, prompt_len + gen_len,
                             dtype=params["embed"].dtype, device=dev)
    tok = first_argmax(logits).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for j in range(gen_len):
        lg, cache = tf.decode_step(params, cache, tok, prompt_len + j, cfg,
                                   backend=backend)
        tok = first_argmax(lg).to(torch.int32)
        out.append(tok)
    synchronize(dev)
    dt = time.perf_counter() - t0
    return torch.stack(out, dim=1), ttft, b * gen_len / dt


def serve_rag(engine, queries, params, cfg: tf.TransformerConfig, *,
              batch: int = 8, prompt_len: int = 64, gen_len: int = 16,
              backend: str | None = None, device=None) -> RagResult:
    """Serve ``queries`` in batches of ``batch`` through ``engine`` (a
    ``HasEngine``) and the generator ``params`` / ``cfg``; a trailing
    partial batch is dropped, as in the reference.  ``engine`` and
    ``params`` must live on ``device`` (CUDA unless ``device="cpu"``).
    ``backend`` switches ``decode_attention`` (None: by device)."""
    dev = resolve_device(device)
    for what, d in (("engine", engine.device),
                    ("params", params["embed"].device)):
        if d.type != dev.type:
            raise ValueError(f"serve_rag: {what} on {d}, serving on {dev}")
    if prompt_len <= QUERY_TOKENS:
        raise ValueError(f"serve_rag: prompt_len must exceed {QUERY_TOKENS}")
    tf.prefill(params, torch.zeros((batch, prompt_len), dtype=torch.int32,
                                   device=dev), cfg)
    synchronize(dev)

    ids, accepts, lats, tokens, ttft, tps = [], [], [], [], [], []
    for start in range(0, len(queries) - batch + 1, batch):
        group = queries[start:start + batch]
        doc_ids = []
        for q in group:
            got, accept, lat, _ = engine.step(q["emb"])
            doc_ids.append(np.asarray(got)[:CTX_IDS])
            accepts.append(accept)
            lats.append(lat)
        ids.extend(doc_ids)
        prompt = torch.as_tensor(build_prompt(group, doc_ids, prompt_len),
                                 dtype=torch.int32, device=dev)
        toks, t, r = generate(params, cfg, prompt, gen_len, backend)
        tokens.append(toks.cpu().numpy())
        ttft.append(t)
        tps.append(r)
    width = gen_len + 1
    return RagResult(
        ids=(np.stack(ids).astype(np.int64) if ids
             else np.zeros((0, CTX_IDS), np.int64)),
        accepts=np.asarray(accepts, bool), retrieval_s=np.asarray(lats),
        tokens=(np.concatenate(tokens) if tokens
                else np.zeros((0, width), np.int32)),
        ttft_s=np.asarray(ttft), decode_tps=np.asarray(tps))
