"""Edge speculation replica pool: R cache replicas behind one delta log.

The port's twin of the reference's ``repro/serving/edge_pool.py``.
:class:`EdgeReplicaPool` holds R warm cache replicas, each an independent
:class:`~repro_torch.core.has.HasState` with tensors of its own, fed from
ONE shared :class:`~repro_torch.serving.replication.DeltaLog` by
bounded-lag delta-cursor replay, so the scheduler (serving/scheduler.py)
can overlap speculation batches of later admissions on *different*
replicas the way full retrievals overlap on cloud workers.

Consistency model (staleness-aware, no phantom accepts):

  * every cache ingest lands on the PRIMARY (the scheduler's authoritative
    state) and is appended to the pool's delta log via ``record_batch`` —
    the same sink protocol ``WarmStandby`` speaks;
  * a replica replays its missing rows once it falls ``sync_every`` or
    more rows behind, so its lag is bounded — either at ``record_batch``
    time (``sync_on_record=True``, the standalone default) or, when the
    owning loop wants replay ON the virtual clock
    (``sync_on_record=False``), at speculation-dispatch time via ``sync``
    with the replay charged to the dispatching edge slot;
  * a speculation batch dispatched to replica r is validated against
    r's OWN cache version (``states[r]`` / ``version(r)``) — an accept
    can only reference documents that replica actually holds;
  * ``promote(r)`` syncs replica r to the log head and hands its state
    over as the new primary.

Replay is exactly the primary's ingest fold (``cache_update_chunked``
row order), so a replica synced to sequence s equals the primary after
its first s ingest rows.  The port's updates mutate a state in place, so
no replica may share a tensor with the primary: ``resync_from`` installs a
clone of every field (the reference copies with ``jnp.copy`` for the same
reason, its donated buffers).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.has import (HasConfig, HasState, cache_update_chunked,
                                  init_has_state, init_tenant_states)
from repro_torch.serving.replication import (DeltaLog, host_copy,
                                             validate_ingest_batch)

#: bounded-lag default: replicas replay once they fall this many ingested
#: rows behind the primary (the reference's calibration: DAR within 2
#: points of the zero-lag R == 1 path while replay stays off the per-batch
#: critical path)
DEFAULT_EDGE_SYNC_EVERY = 32


@dataclasses.dataclass
class EdgeReplicaPool:
    """R speculation cache replicas over one shared delta log.

    ``n_tenants > 1`` replicates a tenant-partitioned primary: delta rows
    carry their tenant tag and replay scatters each row into its tenant's
    partition (the same ``cache_update_chunked`` contract the scheduler's
    own ingest uses).  ``compact=False`` retains the full log (audits /
    tests that fold version prefixes); the default drops rows every
    replica has replayed.
    """
    cfg: HasConfig
    n_replicas: int
    sync_every: int = DEFAULT_EDGE_SYNC_EVERY
    n_tenants: int = 1
    replay_batch: int = 64         # delta rows folded per device dispatch
    compact: bool = True
    # Who applies the bounded-lag cadence.  True (the historical default):
    # ``record_batch`` itself replays any replica that fell ``sync_every``
    # rows behind — replay is then FREE on a serving loop's virtual clock
    # (it happens "inside" the ingest event).  False: the pool only
    # appends; the caller replays at speculation-dispatch time via
    # ``sync`` and charges the replay to the dispatching edge slot
    # (serving/scheduler.py's accounting-fixed mode).
    sync_on_record: bool = True
    device: Any = None

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(
                f"n_replicas must be >= 1, got {self.n_replicas}")
        if self.sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1, got {self.sync_every}")
        self.log = DeltaLog()
        self.states: list[HasState] = [self._init_state()
                                       for _ in range(self.n_replicas)]
        self.cursors = [0] * self.n_replicas
        self.replays = 0               # replay events (stat)
        # replicas whose state was handed over by ``promote`` — their
        # cursors no longer pin compaction and replaying into them would
        # update the new primary in place, out from under it
        self.retired: set[int] = set()
        self._seen_keys: set = set()   # ingest_key dedup (idempotence)

    def _init_state(self) -> HasState:
        return (init_has_state(self.cfg, device=self.device)
                if self.n_tenants == 1 else
                init_tenant_states(self.cfg, self.n_tenants,
                                   device=self.device))

    # -- replica views -----------------------------------------------------

    def version(self, r: int) -> int:
        """Cache version of replica r == primary ingest rows it has
        replayed (the delta-log sequence its cursor sits at)."""
        return self.cursors[r]

    def lag(self, r: int) -> int:
        """Ingested rows replica r is behind the primary."""
        return self.log.head - self.cursors[r]

    def freshest(self, candidates) -> int:
        """Staleness-aware pick: the candidate replica with the highest
        cache version (lowest lag); ties break to the lowest replica id
        (deterministic)."""
        return max(candidates, key=lambda r: (self.cursors[r], -r))

    # -- ingest propagation (the WarmStandby record_batch sink protocol) ---

    def record_batch(self, q_embs, full_ids, full_vecs, state: Any = None,
                     tenant_ids=None, *, ingest_key=None) -> None:
        """Append one primary ingest batch, then apply the sync cadence.

        ``state`` (the post-batch primary) is accepted for sink-protocol
        compatibility with ``WarmStandby.record_batch`` and unused — the
        pool rebuilds replica caches from delta rows alone.  Rows with
        padded (``-1``) ids keep zeroed doc vectors (defensively re-zeroed
        here; replay drops them anyway).

        ``ingest_key`` makes the append IDEMPOTENT: a batch whose key was
        already recorded is dropped whole, so a duplicated replication
        send (or a retried cloud dispatch whose first attempt landed)
        never folds twice into the replicas.  ``None`` skips dedup.
        """
        if ingest_key is not None:
            if ingest_key in self._seen_keys:
                return
            self._seen_keys.add(ingest_key)
        q_embs = host_copy(q_embs, np.float32)
        full_ids = host_copy(full_ids, np.int32)
        full_vecs = host_copy(full_vecs, np.float32)
        validate_ingest_batch(q_embs, full_ids, full_vecs, tenant_ids)
        full_vecs[full_ids < 0] = 0.0  # a host copy: the caller's is kept
        if tenant_ids is None:
            if self.n_tenants > 1:
                raise ValueError(
                    f"record_batch on a {self.n_tenants}-tenant pool "
                    "requires tenant_ids — the rows' partition cannot be "
                    "inferred")
            tids = np.zeros(len(q_embs), np.int32)
        else:
            tids = host_copy(tenant_ids, np.int32)
            if len(tids) and not (0 <= tids.min()
                                  and tids.max() < self.n_tenants):
                raise ValueError(
                    f"tenant ids [{tids.min()}, {tids.max()}] out of range "
                    f"for n_tenants={self.n_tenants}")
        for i in range(len(q_embs)):
            self.log.append((q_embs[i], full_ids[i], full_vecs[i],
                             int(tids[i])))
        if self.sync_on_record:
            for r in range(self.n_replicas):
                if r not in self.retired and self.lag(r) >= self.sync_every:
                    self.sync(r)
        if self.compact:
            self.log.compact_below(self._min_live_cursor())

    def _min_live_cursor(self) -> int:
        """Lowest cursor over NON-retired replicas — the compaction bound.
        Retired (promoted-away) replicas no longer pin the log; with every
        replica retired the whole log may be trimmed."""
        live = [c for r, c in enumerate(self.cursors)
                if r not in self.retired]
        return min(live) if live else self.log.head

    def mark_lost(self, n: int = 1) -> None:
        """Model ``n`` ingest rows LOST on the replication channel: the
        primary folded them, the pool never saw them.  Sequence numbers
        advance without rows, so the next ``sync`` of a lagging replica
        fails loudly on the gap instead of silently diverging."""
        self.log.mark_lost(n)

    # -- bounded-lag delta replay ------------------------------------------

    def sync(self, r: int) -> int:
        """Replay replica r's missing delta rows (cursor -> log head).

        One fused ``cache_update_chunked`` fold per ``replay_batch`` rows,
        in primary ingest order — after the call, replica r is
        bit-identical to the primary's state after its first ``head``
        ingest rows.  Returns the number of rows replayed.

        Replay VALIDATES sequence contiguity: the delta must start at
        replica r's cursor and advance by exactly one per row.  A gap
        means ingest rows were lost in transit (``mark_lost``) — replaying
        past it would silently diverge the replica from the primary, so a
        ``ValueError`` names the replica and the expected/actual sequence;
        the owner must full-resync (``resync_from``).
        """
        if r in self.retired:
            raise ValueError(
                f"replica {r} was retired by promote() — its state now IS "
                "the primary; replaying into it would donate the primary's "
                "buffers")
        items = self.log.since_items(self.cursors[r])
        if not items:
            if self.cursors[r] < self.log.head:
                # every missing row was lost in transit
                raise ValueError(
                    f"delta replay gap for replica {r}: expected seq "
                    f"{self.cursors[r]}, next available is {self.log.head} "
                    "(rows lost in transit) — full resync required")
            return 0
        expected = self.cursors[r]
        for seq, _ in items:
            if seq != expected:
                raise ValueError(
                    f"delta replay gap for replica {r}: expected seq "
                    f"{expected}, got {seq} (rows lost in transit) — "
                    "full resync required")
            expected += 1
        if expected != self.log.head:
            # trailing rows lost after the last retained one
            raise ValueError(
                f"delta replay gap for replica {r}: expected seq "
                f"{expected}, next available is {self.log.head} "
                "(rows lost in transit) — full resync required")
        rows = [row for _, row in items]
        self.states[r] = cache_update_chunked(
            self.cfg, self.states[r],
            np.stack([q for q, _, _, _ in rows]),
            np.stack([ids for _, ids, _, _ in rows]).astype(np.int32),
            np.stack([vecs for _, _, vecs, _ in rows]),
            chunk=self.replay_batch,
            tenant_ids=(None if self.n_tenants == 1 else
                        np.array([t for _, _, _, t in rows], np.int32)))
        self.cursors[r] = self.log.head
        self.replays += 1
        return len(rows)

    def sync_all(self) -> None:
        for r in range(self.n_replicas):
            if r not in self.retired:
                self.sync(r)

    def resync_from(self, r: int, state: HasState, version: int) -> None:
        """Full resync: install a DEEP COPY of ``state`` (the primary at
        delta-log sequence ``version``, normally ``log.head``) as replica
        r's cache and move its cursor there.  The copy is load-bearing:
        replays and ingests update a state in place, so a replica sharing
        the primary's tensors would see every primary ingest (zero lag,
        phantom accepts) and corrupt the primary the first time it syncs.
        This is the recovery path after a crash or a ``sync`` gap error —
        and it un-retires a slot being rebuilt."""
        self.states[r] = HasState(**{
            f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(HasState)})
        self.cursors[r] = version
        self.retired.discard(r)
        self.replays += 1

    def promote(self, r: int) -> HasState:
        """Failover: bring replica r fully up to date and hand its state
        over as the new primary — the request trace continues on exactly
        the cache the lost primary would have had (bit-exact, because
        replay is the primary's own ingest fold).

        The promoted replica is RETIRED: its state now is the primary, so
        its slot must not be replayed into again (in-place updates would
        corrupt the new primary) and its cursor stops pinning log
        compaction — the log can be trimmed past it and stays bounded
        while serving continues.  ``resync_from`` rebuilds the slot."""
        self.sync(r)
        state = self.states[r]
        self.retired.add(r)
        if self.compact:
            self.log.compact_below(self._min_live_cursor())
        return state
