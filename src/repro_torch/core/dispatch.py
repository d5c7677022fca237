"""Host-side accounting of the serving hot path: dispatches, counters and
spans.

A *dispatch* is one host-side call of a public entry point of
``core/has.py`` (``speculate_batch``, ``cache_update``, ...).  Each records
itself here, so benchmarks can assert the dispatch model (e.g. "one
``speculate_batch`` call == one dispatch regardless of B") instead of
inferring it from wall-clock.  The kernels keep their own launch counters
(``repro_torch.kernels.<name>.<name>.launches``); this probe counts the
calls above them.

A *counter* (``count``) adds to a process-global tally of its own
(``counters``) and to the innermost open span.  ``host_syncs`` counts each
place where the host waits for the card (``count_syncs``; none on the
CPU), at the site that waits.

A *span* (``with span(name):``) records its name, its start and end on
``time.perf_counter_ns`` (the clock of ``time.perf_counter``), its id and
its parent's (the innermost span open on the same thread), the micro-batch
id ``step`` that ``span(..., step=True)`` opens and every span inside it
inherits, and the counts taken while it was innermost.  Closed spans go
into a ring of the last ``RING`` (``snapshot``).  While a profiler
collects, each span also opens a ``torch.profiler.record_function`` range
of its name, which places it on the device trace's timeline.  Recording is
two clock reads and an append; nothing syncs the device.

Usage::

    from repro_torch.core import dispatch
    with dispatch.capture() as probe:
        speculate_batch(cfg, state, index, q)     # [B, d]
    assert probe.total() == 1
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator

import torch

RING = 65536                  # spans kept: a run's fill, window and trace

_counts: collections.Counter = collections.Counter()
_tally: collections.Counter = collections.Counter()
_ring: collections.deque = collections.deque(maxlen=RING)
_local = threading.local()
_ids = itertools.count(1)
_steps = itertools.count(1)


def record(name: str) -> None:
    """Count one dispatch attributed to entry point ``name``."""
    _counts[name] += 1


def counts() -> dict[str, int]:
    return dict(_counts)


def counters() -> dict[str, int]:
    return dict(_tally)


def reset() -> None:
    """Clear the dispatch counts, the counters and the ring of spans."""
    _counts.clear()
    _tally.clear()
    _ring.clear()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, globally and in the innermost span."""
    _tally[name] += n
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


def count_syncs(device: torch.device, n: int = 1) -> None:
    """Count ``n`` host waits for ``device`` (``host_syncs``): a CUDA
    synchronize, a copy to or from the host, a boolean-mask index, an
    index by a device scalar.  Nothing waits on the CPU."""
    if device.type == "cuda":
        count("host_syncs", n)


def _profiling() -> bool:
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)


class Span:
    """One timed region; see the module docstring.  ``parent`` and ``step``
    are ``None`` outside any span and any micro-batch."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent",
                 "step", "counts", "_opens_step", "_range")

    def __init__(self, name: str, opens_step: bool = False):
        self.name = name
        self._opens_step = opens_step
        self.counts: dict[str, int] = {}
        self.start_ns = self.end_ns = 0
        self.id = self.parent = self.step = None
        self._range = None

    def __enter__(self) -> Span:
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.step = (next(_steps) if self._opens_step
                     else None if up is None else up.step)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        _ring.append(self)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9


def span(name: str, *, step: bool = False) -> Span:
    """A span named ``name``; ``step=True`` opens a new micro-batch id."""
    return Span(name, step)


def snapshot() -> list[Span]:
    """The closed spans in the ring, oldest first."""
    return list(_ring)


def self_ns(sp: Span, spans) -> int:
    """``sp``'s own time: its length less the union of its children's
    (the spans of ``spans`` whose parent it is), clipped to it."""
    kids = sorted((s.start_ns, s.end_ns) for s in spans if s.parent == sp.id)
    covered, end = 0, sp.start_ns
    for a, b in kids:
        a, b = max(a, end), min(b, sp.end_ns)
        if b > a:
            covered += b - a
            end = b
    return sp.ns - covered


class Capture:
    """Dispatch counts scoped to a ``with dispatch.capture()`` block."""

    def __init__(self, baseline: dict[str, int]):
        self._baseline = baseline

    def counts(self) -> dict[str, int]:
        return {k: v - self._baseline.get(k, 0)
                for k, v in _counts.items()
                if v - self._baseline.get(k, 0) > 0}

    def total(self) -> int:
        return sum(self.counts().values())


@contextlib.contextmanager
def capture() -> Iterator[Capture]:
    yield Capture(dict(_counts))
