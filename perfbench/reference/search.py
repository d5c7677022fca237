"""Top-k by inner product over the corpus in blocks of rows, with a mask of
the rows each query may return.

``precision="f64"`` scores in float64 (the reference).  ``"tf32"`` scores
in float32 with TensorFloat-32 products (the control: the nearest
precision below the configuration's float32 with TF32 off).  A score of
``-inf`` marks a row the query may not return; a position left without a
row is ``(-inf, -1)``.
"""
from __future__ import annotations

import contextlib

import torch

BLOCK = 131072


@contextlib.contextmanager
def precision_scope(precision: str):
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield torch.float64 if precision == "f64" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def exact_block(queries, corpus, dtype):
    """Score function of the plain inner product."""
    q = queries.to(dtype)
    return lambda lo, hi: (q @ corpus[lo:hi].to(dtype).T).double()


def blocked_topk(score, mask, n: int, q: int, k: int, device,
                 block: int = BLOCK):
    """``score(lo, hi) -> [Q, hi-lo]`` f64, ``mask(lo, hi) -> [Q, hi-lo]``
    bool or None -> (vals [Q, k] f64 descending, rows [Q, k] int64)."""
    best_v = torch.full((q, k), -torch.inf, dtype=torch.float64,
                        device=device)
    best_i = torch.full((q, k), -1, dtype=torch.int64, device=device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        s = score(lo, hi)
        if mask is not None:
            s = s.masked_fill(~mask(lo, hi), -torch.inf)
        v, i = torch.topk(s, min(k, hi - lo), dim=1)
        v = torch.cat([best_v, v], dim=1)
        i = torch.cat([best_i, i + lo], dim=1)
        best_v, pos = torch.topk(v, k, dim=1)
        best_i = torch.gather(i, 1, pos)
    best_i = torch.where(torch.isfinite(best_v), best_i, -1)
    return best_v, best_i


def rescore(score_rows, rows: torch.Tensor, ok: torch.Tensor):
    """f64 scores of given rows [Q, k] (``-inf`` where ``ok`` is False or
    the row is negative); ``score_rows(qi, rows)`` scores flat pairs."""
    flat_q = torch.arange(rows.shape[0], device=rows.device)[:, None] \
        .expand_as(rows)
    good = ok & (rows >= 0)
    out = torch.full(rows.shape, -torch.inf, dtype=torch.float64,
                     device=rows.device)
    if good.any():
        out[good] = score_rows(flat_q[good], rows[good])
    return out


def exact_rows(queries, corpus):
    q = queries.double()
    return lambda qi, r: (q[qi] * corpus[r].double()).sum(dim=1)
