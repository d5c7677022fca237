"""HaS edge-cache replication: delta log, snapshot, warm standby, failover.

The port's twin of the reference's ``repro/serving/replication.py``.  Every
cache ingest of the serving scheduler (serving/scheduler.py) fans out over
the delta log below to warm standbys and edge replicas, so a lost cache is
rebuilt from a snapshot plus a replay instead of starting cold:

  * ``DeltaLog``: an append-only log of cache_update inputs with monotone
    global sequence numbers, consumed clear-on-snapshot style by
    ``WarmStandby`` and delta-cursor style by the edge speculation replica
    pool (``serving/edge_pool.py::EdgeReplicaPool``).  Lost appends
    surface as a sequence gap at replay; duplicated appends are dropped by
    per-batch ingest keys.  Pure Python, as in the reference.
  * ``snapshot`` / ``restore``: the ``HasState`` tensors (query cache, doc
    store, ring pointers) and a tenant-layout stamp through the port's
    checkpoint manager (atomic, validated); ``restore`` builds the state on
    the device it is asked for.  The fuzzy IVF index is derived state and
    is rebuilt from the corpus, not checkpointed.
  * ``WarmStandby``: per-tenant delta logs since the last snapshot,
    replayed onto the restored snapshot at ``failover()`` through
    ``cache_update_chunked``.

The port's cache updates mutate their state IN PLACE, where the
reference's return new arrays.  So nothing here may share a tensor with
the primary: every row a log keeps is a host copy, the checkpoint manager
copies a state before its writer thread sees it, and a restored or
failed-over state is built from the files, never from the primary.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.has import (HasConfig, HasState, cache_update_chunked,
                                  init_has_state, init_tenant_states)


def host_copy(x, dtype) -> np.ndarray:
    """A host copy of ``x`` (a tensor on any device, or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy().astype(dtype,
                                                              copy=False)
    return np.array(x, dtype)


def validate_ingest_batch(q_embs, full_ids, full_vecs,
                          tenant_ids=None) -> None:
    """All leading dimensions of one ingest batch must agree.

    The recording loops iterate the four arrays in lockstep; a bare
    ``zip`` would silently DROP tail rows when one argument is shorter
    (diverging the replica from the primary with no error), so every
    recorder validates up front and raises instead.
    """
    lens = {"q_embs": len(q_embs), "full_ids": len(full_ids),
            "full_vecs": len(full_vecs)}
    if tenant_ids is not None:
        lens["tenant_ids"] = len(tenant_ids)
    if len(set(lens.values())) > 1:
        raise ValueError(
            "ingest batch leading dimensions disagree ("
            + ", ".join(f"{k}={v}" for k, v in lens.items())
            + ") — a zip over them would silently drop tail rows")


def gather_doc_vecs(corpus_np: np.ndarray,
                    full_ids: np.ndarray) -> np.ndarray:
    """Gather ``[..., k]`` doc ids -> ``[..., k, d]`` corpus rows, with
    padded (``-1``) ids ZEROED.

    A full search emits ``-1`` ids when the corpus holds fewer than k rows
    (the reference's sharded searches do too); a raw
    ``corpus_np[full_ids]`` wraps those pythonically and silently gathers
    the LAST corpus row into every padded slot, corrupting replica delta
    logs.  Zero vectors are inert on replay (``cache_update`` drops
    ``id < 0`` rows before they touch the doc store).
    """
    full_ids = np.asarray(full_ids)
    vecs = np.asarray(corpus_np)[np.maximum(full_ids, 0)]
    vecs = vecs.astype(np.float32, copy=True)
    vecs[full_ids < 0] = 0.0
    return vecs


class DeltaLog:
    """Append-only ingest log with EXPLICIT monotone sequence numbers.

    Every retained row is stored as ``(seq, payload)``: the i-th append
    (0-based since the log's creation) gets sequence number ``i`` forever,
    even after eviction/compaction — ``base`` is the sequence of the
    oldest retained row and ``head`` is one past the newest sequence ever
    PRODUCED.  Two consumption styles share it:

    * clear-on-snapshot (``WarmStandby``): ``clear()`` after a snapshot —
      ``failover`` replays whatever is currently held.
    * delta-cursor (``EdgeReplicaPool``): each replica remembers the
      sequence it has replayed up to and asks ``since(cursor)`` for the
      rows it is missing; nothing is cleared, and ``compact_below`` drops
      rows every cursor has passed.

    ``maxlen`` bounds memory the deque way: appending to a full log
    evicts the oldest row and advances ``base``, so a cursor that has
    fallen behind ``base`` detects (``LookupError``) that it must full
    resync rather than silently skipping rows.

    The sequences are explicit (not implied by position) so that LOST
    replication traffic is detectable: ``mark_lost(n)`` consumes ``n``
    sequence numbers without appending rows — the producer ingested
    them, the channel dropped them — and a consumer replaying across the
    resulting gap sees non-consecutive sequences from ``since_items``
    (``EdgeReplicaPool.sync`` raises a ``ValueError`` naming the replica
    and the expected/actual sequence instead of silently diverging).
    """

    def __init__(self, maxlen: int | None = None):
        self._rows: deque = deque(maxlen=maxlen)
        self._next = 0                     # next sequence to hand out

    @property
    def base(self) -> int:
        """Sequence of the oldest retained row (``head`` when empty)."""
        return self._rows[0][0] if self._rows else self._next

    @property
    def head(self) -> int:
        """One past the newest sequence ever produced (lost rows count)."""
        return self._next

    def append(self, row) -> None:
        self._rows.append((self._next, row))   # full deque evicts oldest
        self._next += 1

    def mark_lost(self, n: int = 1) -> None:
        """Consume ``n`` sequence numbers without retaining rows — the
        producer ingested them but the replication channel dropped them.
        Consumers replaying across the gap detect it via ``since_items``
        (non-consecutive sequences) rather than silently skipping rows."""
        if n < 0:
            raise ValueError(f"mark_lost needs n >= 0, got {n}")
        self._next += n

    def clear(self) -> None:
        self._rows.clear()

    def since_items(self, cursor: int) -> list:
        """``(seq, row)`` pairs with seq >= cursor.  Consecutive-sequence
        validation is the CONSUMER's job (a gap means rows were lost in
        transit)."""
        if cursor < self.base:
            raise LookupError(
                f"cursor {cursor} has fallen behind the log base "
                f"{self.base} (rows were evicted) — the consumer must "
                "full-resync from a snapshot")
        # rows are seq-sorted; skip the replayed prefix
        skip = 0
        for seq, _ in self._rows:
            if seq >= cursor:
                break
            skip += 1
        return list(itertools.islice(self._rows, skip, None))

    def since(self, cursor: int) -> list:
        """Rows with sequence >= cursor (the delta a consumer is missing)."""
        return [row for _, row in self.since_items(cursor)]

    def compact_below(self, cursor: int) -> None:
        """Drop rows every consumer has replayed (min cursor over them)."""
        while self._rows and self._rows[0][0] < cursor:
            self._rows.popleft()

    def __len__(self) -> int:
        return len(self._rows)

    def __iter__(self):
        return iter(row for _, row in self._rows)


def _tenant_stamp(state: HasState) -> int:
    """Layout stamp persisted with a snapshot: 0 == the historical
    unstacked single-tenant layout; T >= 1 == a stacked
    ``init_tenant_states`` store with T partitions (a stacked ``[1, ...]``
    store stamps 1, distinguishing it from the unstacked layout whose
    tensor shapes may otherwise be compatible)."""
    return int(state.q_ptr.shape[0]) if state.q_ptr.ndim else 0


def _stamp_name(stamp: int) -> str:
    return ("the historical unstacked single-tenant layout" if stamp == 0
            else f"a stacked {stamp}-tenant store")


_FIELDS = ("query_emb", "query_doc_ids", "query_valid", "q_ptr", "doc_emb",
           "doc_ids", "d_ptr")


def snapshot(mgr: CheckpointManager, step: int, state: HasState,
             blocking: bool = True) -> None:
    """Persist the ``HasState`` tensors (+ their tenant-layout stamp).

    Safe to call with ``blocking=False`` right before an in-place ingest:
    the checkpoint manager copies every tensor to host memory before its
    writer thread sees it.
    """
    tree = {f: getattr(state, f) for f in _FIELDS}
    tree["n_tenants"] = np.int32(_tenant_stamp(state))
    mgr.save(step, tree, blocking=blocking)


def restore(mgr: CheckpointManager, cfg: HasConfig, n_tenants: int = 1,
            device=None) -> tuple[int, HasState] | None:
    """Restore the latest snapshot onto ``device`` (CUDA unless asked),
    validating its tenant layout.

    The checkpoint records the layout it was saved with
    (:func:`_tenant_stamp`); restoring with a different ``n_tenants``
    raises a clear ``ValueError`` instead of an opaque downstream shape
    mismatch, or a silent misread between the unstacked T == 1 layout and
    a stacked store of compatible shapes.  Pre-stamp checkpoints (no
    ``n_tenants`` leaf) restore without validation.
    """
    template = (init_has_state(cfg, device=device) if n_tenants == 1
                else init_tenant_states(cfg, n_tenants, device=device))
    tree = {f: getattr(template, f) for f in _FIELDS}
    try:
        out = mgr.restore_latest({**tree,
                                  "n_tenants": np.zeros((), np.int32)})
        stamp = None if out is None else int(out[1].pop("n_tenants"))
    except KeyError:                   # pre-stamp checkpoint: no layout leaf
        out = mgr.restore_latest(dict(tree))
        stamp = None
    if out is None:
        return None
    step, t = out
    expected = 0 if n_tenants == 1 else n_tenants
    if stamp is not None and stamp != expected:
        raise ValueError(
            f"checkpoint at step {step} holds {_stamp_name(stamp)} but "
            f"restore requested n_tenants={n_tenants} "
            f"({_stamp_name(expected)}) — pass the tenant count the state "
            "was snapshotted with")
    return step, HasState(**{f: t[f] for f in _FIELDS})


@dataclasses.dataclass
class WarmStandby:
    """Delta-log replication for a standby HaS engine.

    ``n_tenants > 1`` replicates a tenant-partitioned primary
    (``core/has.py::init_tenant_states``): the delta log is PER TENANT
    (one deque each, so ``max_lag`` bounds every tenant's acceptance-rate
    loss independently), and ``failover`` replays each tenant's log into
    its own partition, rebuilding every partition exactly.  ``n_tenants
    == 1`` is the single-log path (``self.log``).  ``device`` is where a
    failed-over state is built (CUDA unless asked).
    """
    cfg: HasConfig
    mgr: CheckpointManager
    snapshot_every: int = 500
    max_lag: int = 1000
    replay_batch: int = 64         # delta entries folded per device dispatch
    n_tenants: int = 1
    device: Any = None

    def __post_init__(self):
        self.logs: list[DeltaLog] = [DeltaLog(maxlen=self.max_lag)
                                     for _ in range(self.n_tenants)]
        self._since_snapshot = 0
        self._step = 0
        self._seen_keys: set = set()

    @property
    def log(self) -> DeltaLog:
        """Tenant-0 delta log (the whole log when ``n_tenants == 1``)."""
        return self.logs[0]

    def record_update(self, q_emb, full_ids, full_vecs, state: HasState,
                      tenant_id: int = 0) -> None:
        """Call after every primary cache_update."""
        self.record_batch(host_copy(q_emb, np.float32)[None],
                          host_copy(full_ids, np.int32)[None],
                          host_copy(full_vecs, np.float32)[None], state,
                          tenant_ids=np.array([tenant_id], np.int32))

    def record_batch(self, q_embs, full_ids, full_vecs, state: HasState,
                     tenant_ids=None, *, ingest_key=None) -> None:
        """Append a whole ingest batch, then apply the snapshot cadence ONCE.

        ``state`` must be the post-batch primary state.  The cadence check
        runs after ALL rows are appended: snapshotting mid-batch would
        clear the log while the batch tail still gets appended, and a
        failover would then replay rows the snapshot already contains.  An
        exactly-full batch therefore snapshots once, after the last row,
        with an empty log left behind.

        ``tenant_ids [N]`` routes each row to its tenant's delta log and is
        REQUIRED when ``n_tenants > 1``.  ``ingest_key`` makes the append
        IDEMPOTENT: a batch whose key was already recorded is dropped whole
        (a retried cloud dispatch whose first attempt landed must not fold
        twice).  ``None`` skips dedup.  Rows are kept as host copies.
        """
        if ingest_key is not None:
            if ingest_key in self._seen_keys:
                return
            self._seen_keys.add(ingest_key)
        validate_ingest_batch(q_embs, full_ids, full_vecs, tenant_ids)
        if tenant_ids is None:
            if self.n_tenants > 1:
                raise ValueError(
                    f"record_batch on a {self.n_tenants}-tenant standby "
                    "requires tenant_ids — the rows' partition cannot be "
                    "inferred")
            tenant_ids = np.zeros(len(q_embs), np.int32)
        else:
            tenant_ids = host_copy(tenant_ids, np.int32)
            if len(tenant_ids) and not (0 <= tenant_ids.min()
                                        and tenant_ids.max()
                                        < self.n_tenants):
                raise ValueError(
                    f"tenant ids [{tenant_ids.min()}, {tenant_ids.max()}] "
                    f"out of range for n_tenants={self.n_tenants}")
        q_embs = host_copy(q_embs, np.float32)
        full_ids = host_copy(full_ids, np.int32)
        full_vecs = host_copy(full_vecs, np.float32)
        for q, ids, vecs, t in zip(q_embs, full_ids, full_vecs, tenant_ids):
            self.logs[int(t)].append((q, ids, vecs))
        self._since_snapshot += len(q_embs)
        self._step += len(q_embs)
        if self._since_snapshot >= self.snapshot_every:
            snapshot(self.mgr, self._step, state, blocking=False)
            self._since_snapshot = 0
            for log in self.logs:
                log.clear()

    def failover(self) -> HasState:
        """Rebuild the freshest possible state on the standby.

        Each tenant's delta log replays into its own partition through
        ``cache_update_chunked``, ``replay_batch`` rows a chunk (padded,
        masked).  With no snapshot and empty logs this is a cold start
        (fresh state).
        """
        self.mgr.wait()
        out = restore(self.mgr, self.cfg, n_tenants=self.n_tenants,
                      device=self.device)
        if out is not None:
            state = out[1]
        elif self.n_tenants == 1:
            state = init_has_state(self.cfg, device=self.device)
        else:
            state = init_tenant_states(self.cfg, self.n_tenants,
                                       device=self.device)
        for t, log_t in enumerate(self.logs):
            log = list(log_t)
            if not log:
                continue
            state = cache_update_chunked(
                self.cfg, state,
                np.stack([q for q, _, _ in log]),
                np.stack([ids for _, ids, _ in log]).astype(np.int32),
                np.stack([vecs for _, _, vecs in log]),
                chunk=self.replay_batch,
                tenant_ids=(None if self.n_tenants == 1
                            else np.full(len(log), t, np.int32)))
        return state
