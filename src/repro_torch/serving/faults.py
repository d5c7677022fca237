"""Deterministic fault injection for the serving scheduler.

Chaos testing for the HaS serving stack, with the same purity contract as
everything else in the repo: a :class:`FaultPlan` is an explicit, ordered
set of fault events pinned to the scheduler's VIRTUAL clock, so a chaos
run is a pure function of ``(seed, plan, arrivals, queries)`` — the same
plan replays the same crash at the same virtual instant every time, and
an empty plan is bit-identical to not having this module at all.  A copy
of the reference's module (``repro/serving/faults.py``): no device code.

Fault model (``KINDS``):

``worker_crash``
    Cloud full-retrieval worker ``target`` dies at ``t``.  Its in-flight
    batch is lost and requeued by the scheduler; the worker rejoins the
    pool after ``down_s`` virtual seconds (``0`` = permanent).
``straggler``
    Worker ``target``'s service latency is multiplied by ``factor`` for
    dispatches STARTING in ``[t, t + duration_s)`` — the slow-node tail
    that deadlines + hedged re-dispatch are built to cut.
``search_fail``
    Dispatches to worker ``target`` starting in ``[t, t + duration_s)``
    fail transiently: the failure surfaces after the full service time
    and the scheduler retries with exponential backoff (bounded by
    ``retry_max``).
``replica_crash``
    Edge speculation replica ``target`` dies at ``t`` mid-stream: its
    in-flight speculation batch is rerouted to the full-retrieval
    channel and the slot is rebuilt in the background from the primary +
    shared delta log.
``delta_drop``
    The next ``count`` replication appends after ``t`` are LOST on the
    channel (the primary folded them, the replicas never see them) —
    surfaces as a sequence gap at the next delta replay.
``delta_dup``
    The next ``count`` replication appends after ``t`` are DUPLICATED on
    the channel — absorbed by idempotent ingest keys (a correct run is
    bit-identical to fault-free; that IS the no-duplicate-fold verdict).

:class:`FaultInjector` is the per-``serve()`` runtime view: the scheduler
pushes each event onto its heap, activates windows/counters here as they
fire, and queries the active fault set at dispatch/ingest time.  No rng
is drawn anywhere in this module.
"""
from __future__ import annotations

import dataclasses

KINDS = ("worker_crash", "straggler", "search_fail", "replica_crash",
         "delta_drop", "delta_dup")

#: kinds whose window fields (duration_s) are meaningful
_WINDOW_KINDS = ("straggler", "search_fail")
_DELTA_KINDS = ("delta_drop", "delta_dup")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault pinned to the virtual clock.  Field meaning varies by
    ``kind`` (see the module docstring); irrelevant fields are ignored."""
    t: float                  # virtual time the fault fires
    kind: str                 # one of KINDS
    target: int = 0           # worker id / replica id (ignored for delta_*)
    duration_s: float = 0.0   # straggler / search_fail window length
    factor: float = 4.0       # straggler service-latency multiplier
    down_s: float = 0.0       # worker_crash downtime (0 = permanent)
    count: int = 1            # delta_drop / delta_dup: appends affected


# parse() key aliases -> FaultEvent field
_PARSE_KEYS = {
    "target": ("target", int),
    "duration": ("duration_s", float),
    "duration_s": ("duration_s", float),
    "factor": ("factor", float),
    "down": ("down_s", float),
    "down_s": ("down_s", float),
    "count": ("count", int),
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, validated set of :class:`FaultEvent`.

    Events may be given in any order; consumers see them sorted by
    ``(t, original index)``.  An EMPTY plan is the fault-free contract:
    the scheduler must behave bit-identically to one built without a
    plan at all.
    """
    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for i, ev in enumerate(self.events):
            if not isinstance(ev, FaultEvent):
                raise TypeError(
                    f"events[{i}] is {type(ev).__name__}, expected "
                    "FaultEvent")
            if ev.kind not in KINDS:
                raise ValueError(
                    f"events[{i}]: unknown fault kind {ev.kind!r} "
                    f"(choose from {', '.join(KINDS)})")
            if not ev.t >= 0.0:
                raise ValueError(
                    f"events[{i}] ({ev.kind}): t must be >= 0, got {ev.t}")
            if ev.target < 0:
                raise ValueError(
                    f"events[{i}] ({ev.kind}): target must be >= 0, "
                    f"got {ev.target}")
            if ev.kind in _WINDOW_KINDS and not ev.duration_s > 0.0:
                raise ValueError(
                    f"events[{i}] ({ev.kind}): duration_s must be > 0, "
                    f"got {ev.duration_s}")
            if ev.kind == "straggler" and not ev.factor > 1.0:
                raise ValueError(
                    f"events[{i}] (straggler): factor must be > 1, "
                    f"got {ev.factor}")
            if ev.kind == "worker_crash" and ev.down_s < 0.0:
                raise ValueError(
                    f"events[{i}] (worker_crash): down_s must be >= 0, "
                    f"got {ev.down_s}")
            if ev.kind in _DELTA_KINDS and ev.count < 1:
                raise ValueError(
                    f"events[{i}] ({ev.kind}): count must be >= 1, "
                    f"got {ev.count}")

    def __len__(self) -> int:
        return len(self.events)

    def sorted_events(self) -> list:
        """Events in firing order (stable on simultaneous faults)."""
        return sorted(self.events, key=lambda e: e.t)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the CLI grammar: ``;``-separated events, each
        ``kind@t[,key=val]*`` — e.g.::

            worker_crash@2.0,target=0,down=3.0;straggler@1.0,duration=5,factor=4

        Keys: ``target``, ``duration``, ``factor``, ``down``, ``count``.
        An empty/whitespace spec is the empty plan.
        """
        events = []
        for i, part in enumerate(p for p in spec.split(";") if p.strip()):
            head, *kvs = [f.strip() for f in part.split(",")]
            if "@" not in head:
                raise ValueError(
                    f"fault event {i} ({head!r}): expected 'kind@t', e.g. "
                    "'worker_crash@2.0'")
            kind, _, t_s = head.partition("@")
            kind = kind.strip()
            try:
                t = float(t_s)
            except ValueError:
                raise ValueError(
                    f"fault event {i} ({head!r}): time {t_s!r} is not a "
                    "number") from None
            fields = {}
            for kv in kvs:
                key, sep, val = kv.partition("=")
                key = key.strip()
                if not sep or key not in _PARSE_KEYS:
                    raise ValueError(
                        f"fault event {i} ({kind}): bad field {kv!r} "
                        f"(keys: {', '.join(sorted(set(_PARSE_KEYS)))})")
                name, conv = _PARSE_KEYS[key]
                try:
                    fields[name] = conv(val)
                except ValueError:
                    raise ValueError(
                        f"fault event {i} ({kind}): {key}={val!r} is not "
                        f"a valid {conv.__name__}") from None
            events.append(FaultEvent(t=t, kind=kind, **fields))
        return cls(events=tuple(events))


class FaultInjector:
    """Per-run mutable view of a :class:`FaultPlan`.

    The scheduler owns WHEN faults fire (it schedules each event on its
    heap); this object owns WHAT is currently broken: active straggler /
    search-failure windows and pending delta-channel faults.  Crash
    events (worker/replica) carry no window state — the scheduler reacts
    to them directly.  Everything here is deterministic bookkeeping.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._stragglers: list = []    # (t0, t1, worker, factor)
        self._search_fail: list = []   # (t0, t1, worker)
        self._drop_pending = 0
        self._dup_pending = 0
        # stats (mirrored into SchedResult by the scheduler)
        self.dropped_appends = 0
        self.duplicated_appends = 0

    def activate(self, ev: FaultEvent) -> None:
        """Arm windowed/counted faults when their heap event fires.
        Crash kinds are intentionally no-ops here."""
        if ev.kind == "straggler":
            self._stragglers.append(
                (ev.t, ev.t + ev.duration_s, ev.target, ev.factor))
        elif ev.kind == "search_fail":
            self._search_fail.append((ev.t, ev.t + ev.duration_s, ev.target))
        elif ev.kind == "delta_drop":
            self._drop_pending += ev.count
        elif ev.kind == "delta_dup":
            self._dup_pending += ev.count

    # -- dispatch-time queries --------------------------------------------

    def latency_multiplier(self, worker: int, t: float) -> float:
        """Service-latency multiplier for a dispatch to ``worker``
        STARTING at ``t`` (overlapping straggler windows compound)."""
        m = 1.0
        for t0, t1, w, factor in self._stragglers:
            if w == worker and t0 <= t < t1:
                m *= factor
        return m

    def search_fails(self, worker: int, t: float) -> bool:
        """True iff a dispatch to ``worker`` starting at ``t`` fails
        transiently (decided at dispatch time; surfaces at completion)."""
        return any(w == worker and t0 <= t < t1
                   for t0, t1, w in self._search_fail)

    # -- ingest-time queries ----------------------------------------------

    def delta_fault(self) -> str | None:
        """Consume one pending delta-channel fault for the next append:
        ``"drop"`` | ``"dup"`` | ``None``.  Drops take priority when both
        are pending (deterministic)."""
        if self._drop_pending > 0:
            self._drop_pending -= 1
            self.dropped_appends += 1
            return "drop"
        if self._dup_pending > 0:
            self._dup_pending -= 1
            self.duplicated_appends += 1
            return "dup"
        return None
