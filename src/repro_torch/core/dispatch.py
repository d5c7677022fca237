"""Host-side entry-point accounting for the serving hot path.

A *dispatch* is one host-side call of a public entry point of
``core/has.py`` (``speculate_batch``, ``cache_update``, ...).  Each records
itself here, so benchmarks can assert the dispatch model (e.g. "one
``speculate_batch`` call == one dispatch regardless of B") instead of
inferring it from wall-clock.  The kernels keep their own launch counters
(``repro_torch.kernels.<name>.<name>.launches``); this probe counts the
calls above them.

The probe is a process-global counter keyed by entry-point name; recording
is a dict increment (no device sync).

Usage::

    from repro_torch.core import dispatch
    with dispatch.capture() as probe:
        speculate_batch(cfg, state, index, q)     # [B, d]
    assert probe.total() == 1
"""
from __future__ import annotations

import collections
import contextlib
from typing import Iterator

_counts: collections.Counter = collections.Counter()


def record(name: str) -> None:
    """Count one dispatch attributed to entry point ``name``."""
    _counts[name] += 1


def counts() -> dict[str, int]:
    return dict(_counts)


def reset() -> None:
    _counts.clear()


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
