"""Peaks of one H100 and the work of each operation of a HaS micro-batch.

Peaks (NVIDIA's data sheet, H100 SXM, dense): 67 TFLOP/s float32 outside
the tensor cores (integer compares are counted at the same rate), 495
TF32, 989 bf16, 3.35 TB/s of HBM.  An operation's least time is the larger
of its operations over the peak of its type and its bytes over the HBM
rate.  Work is counted from the shapes and the data the inputs touch, not
from the kernel that runs it: each input byte read once, each output byte
written once, and of a bucket scan only the rows the probed buckets hold
(a bucket probed by several queries of a batch is read once).
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def least_s(ops: float, nbytes: float, kind: str = "f32") -> float:
    return max(ops / PEAK_OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S)


def cache_topk(b: int, rows: int, d: int, k: int) -> float:
    """The cache channel: ``b`` queries against ``rows`` held ring rows."""
    return least_s(2.0 * b * rows * d,
                   4.0 * rows * d + rows + 4.0 * b * d + 8.0 * b * k)


def probe_product(b: int, c: int, d: int, p: int) -> float:
    """Centroid scores and the top-``p`` buckets of ``b`` queries."""
    return least_s(2.0 * b * c * d, 4.0 * c * d + 4.0 * b * d + 8.0 * b * p)


def bucket_scan(probe: np.ndarray, counts: np.ndarray, d: int, k: int,
                code_bytes: float) -> float:
    """A scan of the probed buckets (``probe [b, P]``, ``counts [C]`` rows
    held) storing ``code_bytes`` a row (ids and scales included)."""
    b, p = probe.shape
    rows_scored = float(counts[probe].sum())
    rows_read = float(counts[np.unique(probe)].sum())
    return least_s(2.0 * d * rows_scored,
                   rows_read * code_bytes + 4.0 * b * d + 8.0 * b * p
                   + 8.0 * b * k)


def homology(b: int, h: int, k: int) -> float:
    """Validation: ``b`` drafts against ``h`` cached rows of ``k`` ids."""
    return least_s(float(b) * h * k * k, 4.0 * h * k + h + 4.0 * b * k + 8 * b)


def exact_scan(r: int, n: int, d: int, k: int) -> float:
    """The exact cloud scan of ``r`` rejects over ``n`` f32 rows."""
    if r == 0:
        return 0.0
    return least_s(2.0 * r * n * d, 4.0 * n * d + 4.0 * r * d + 8.0 * r * k)


def ingest(r: int, new_docs: int, k: int, d: int, doc_cap: int) -> float:
    """The fold of ``r`` rejects: their ``k`` rows gathered, each id looked
    up in the doc ring, the query rows and the ``new_docs`` docs the fold
    appended written."""
    if r == 0:
        return 0.0
    return least_s(float(r) * k * doc_cap,
                   r * (4.0 * k * d + 4.0 * doc_cap + 4.0 * d + 4.0 * k)
                   + new_docs * (4.0 * d + 4.0))
