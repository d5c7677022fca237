"""Per-stage virtual-clock tracing for the continuous-batching scheduler.

Every request served by ``ContinuousBatchingScheduler`` records a span
breakdown of its end-to-end latency on the virtual clock — one float per
stage, summing EXACTLY to ``t_done - t_arrive`` (the conservation property
the reference's tests and ``tests/test_torch_faults.py`` assert for every
channel):

  ``queue_wait``   admission-queue wait until its speculation batch
                   dispatches
  ``replay``       bounded-lag delta replay charged to the dispatching edge
                   slot (the serving replica catches up to the primary
                   before the batch runs; 0 when the replica was fresh or
                   R == 1)
  ``spec``         speculation-batch service time (fuzzy + cache-channel
                   scans)
  ``edge_rtt``     edge network round trip of the response
  ``reval_wait``   rejected-leader queue wait that ended in a late
                   re-validation accept (the ``reval`` channel's cloud-side
                   wait — no cloud work was done)
  ``cloud_queue``  full-retrieval queue wait until the cloud batch
                   dispatched (followers: until their leader's batch
                   dispatched, clipped at their own rejection time)
  ``cloud``        cloud RTT + coalesced full-scan service time
  ``ingest``       cache-ingest share: the ``cache_update_chunked`` fold +
                   ``on_ingest`` fan-out of the completed batch, charged on
                   the cloud-done path to every request returning from it
  ``lost``         virtual time thrown away by faults (serving/faults.py):
                   a crashed worker's partial service, a cancelled
                   straggler's head start over the hedge that beat it, a
                   failed search attempt, or a dead edge replica's
                   discarded speculation — work the request paid for but
                   that produced nothing
  ``retry_backoff`` exponential-backoff wait between a failed cloud
                   attempt and its retry dispatch
  ``reason``       agent reasoning time of a hop sub-query
                   (serving/agentic.py): the LLM synthesis step that turned
                   the previous hop's result into this hop's sub-query
                   (charged before the request enters admission), plus —
                   on a complex query's final hop — the trailing
                   answer-synthesis step after the last retrieval lands

Stages a request never enters stay 0 (e.g. a ``draft`` accept has only
``queue_wait``/``replay``/``spec``/``edge_rtt``; a ``shed`` rejection has
all-zero spans and ``t_done == t_arrive``; ``lost``/``retry_backoff``
stay 0 in any fault-free run; ``reason`` stays 0 for every non-agentic
request).

:class:`Trace` is the result-side container: per-request span arrays plus
``stage_breakdown()`` (aggregate seconds/fraction per stage) and
``timeline(bucket_s)`` (per-virtual-time-bucket stage mass, keyed by each
request's completion bucket) for benchmarks to assert on.  Tracing is
bookkeeping only — it never advances the virtual clock (tracing off gives
the same schedule, bit-exactly).  A copy of the reference's module
(``repro/serving/tracing.py``): numpy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: span keys, in pipeline order (see module docstring)
STAGES = ("queue_wait", "replay", "spec", "edge_rtt", "reval_wait",
          "cloud_queue", "cloud", "ingest", "lost", "retry_backoff",
          "reason")


def empty_spans() -> dict[str, float]:
    """One request's span accumulator (all stages, zeroed)."""
    return {s: 0.0 for s in STAGES}


@dataclasses.dataclass
class Trace:
    """Per-request span breakdown of one scheduler stream (virtual clock).

    ``spans[stage]`` is a ``[n]`` float array of seconds; for every request
    ``sum_stage spans[stage][i] == t_done[i] - t_arrive[i]`` exactly.
    """
    t_arrive: np.ndarray                 # [n]
    t_done: np.ndarray                   # [n]
    channels: np.ndarray                 # [n] completion channel per request
    spans: dict[str, np.ndarray]         # stage -> [n] seconds

    @property
    def n(self) -> int:
        return len(self.t_arrive)

    def total(self) -> np.ndarray:
        """Per-request sum of spans (== end-to-end latency)."""
        if not self.n:
            return np.zeros(0)
        return np.sum([self.spans[s] for s in STAGES], axis=0)

    def conservation_residual(self) -> np.ndarray:
        """(t_done - t_arrive) - sum(spans): ~0 for every request."""
        return (self.t_done - self.t_arrive) - self.total()

    def stage_breakdown(self, channels=None) -> dict[str, dict[str, float]]:
        """Aggregate seconds per stage: total / mean-per-request / fraction
        of the stream's total latency mass.  ``channels`` (optional)
        restricts to requests completing on those channels.  NaN-safe on an
        empty stream (or an empty channel selection)."""
        if channels is None:
            m = np.ones(self.n, bool)
        else:
            m = np.isin(self.channels, np.asarray(channels))
        nsel = int(m.sum())
        mass = float(sum(self.spans[s][m].sum() for s in STAGES))
        out = {}
        for s in STAGES:
            tot = float(self.spans[s][m].sum()) if nsel else 0.0
            out[s] = {
                "total_s": tot,
                "mean_s": tot / nsel if nsel else float("nan"),
                "frac": tot / mass if mass > 0 else float("nan"),
            }
        return out

    def timeline(self, bucket_s: float) -> dict[str, np.ndarray]:
        """Stage mass per virtual-time bucket.

        Buckets the stream by COMPLETION time (``t_done``) into windows of
        ``bucket_s`` seconds from the first arrival, attributing each
        request's full span breakdown to its completion bucket — the
        load-over-time view overload benchmarks assert on (queue-wait mass
        exploding past saturation, shed keeping it flat).  Returns
        ``{"t": bucket start times [B], "n": completions per bucket [B],
        <stage>: seconds per bucket [B]}``.
        """
        if bucket_s <= 0:
            raise ValueError(f"bucket_s must be > 0, got {bucket_s}")
        if not self.n:
            z = np.zeros(0)
            return {"t": z, "n": z.astype(np.int64),
                    **{s: z.copy() for s in STAGES}}
        t0 = float(self.t_arrive.min())
        idx = np.floor((self.t_done - t0) / bucket_s).astype(np.int64)
        idx = np.maximum(idx, 0)
        nb = int(idx.max()) + 1
        out = {"t": t0 + bucket_s * np.arange(nb),
               "n": np.bincount(idx, minlength=nb)}
        for s in STAGES:
            out[s] = np.bincount(idx, weights=self.spans[s], minlength=nb)
        return out


def build_trace(reqs, t_arrive: np.ndarray, t_done: np.ndarray,
                channels: np.ndarray) -> Trace:
    """Assemble a :class:`Trace` from the scheduler's ``_Request`` list
    (each carrying a ``spans`` dict, possibly partially filled)."""
    spans = {s: np.array([r.spans.get(s, 0.0) for r in reqs])
             for s in STAGES}
    return Trace(t_arrive=t_arrive, t_done=t_done, channels=channels,
                 spans=spans)
