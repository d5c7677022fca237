"""Fault tolerance at scale: straggler mitigation + elastic restart logic.

A copy of the reference's ``repro/training/fault.py`` (numpy and ``time``
only); the scheduler's hedging deadline is ``StragglerDetector``.

These are the host-side control-plane pieces; checkpoint/manager.py is the
data plane.  In a real multi-host deployment the watchdog runs per host and
coordinates through the cluster scheduler; here the policies are implemented
and unit-tested against simulated step-time traces / failure events.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    window: int = 20              # trailing steps for the baseline estimate
    deadline_factor: float = 3.0  # step > factor * median -> straggler
    min_samples: int = 5


class StragglerDetector:
    """Per-step deadline watchdog (MTTR control for slow/hung hosts).

    Policy: keep a trailing median of healthy step times; a step exceeding
    ``deadline_factor x median`` flags the host.  The caller's remediation is
    pluggable: re-dispatch the step (redundant execution), evict the host
    (elastic downscale), or checkpoint-and-restart.
    """

    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.history: deque[float] = deque(maxlen=cfg.window)
        self.flagged: list[int] = []

    @property
    def deadline(self) -> float | None:
        if len(self.history) < self.cfg.min_samples:
            return None
        return float(np.median(self.history) * self.cfg.deadline_factor)

    def observe(self, step: int, elapsed: float) -> bool:
        """Returns True if this step is a straggler."""
        d = self.deadline
        is_straggler = d is not None and elapsed > d
        if is_straggler:
            self.flagged.append(step)
        else:
            self.history.append(elapsed)
        return is_straggler


@dataclasses.dataclass
class ElasticPlan:
    """Resolution of a mesh rescale after node loss/gain.

    The data axis absorbs the change (batch re-split); model/pod axes are
    topology-constrained and never resized mid-job.  A shrink from
    data=16 -> data=12 keeps global batch via gradient accumulation:
    accum_steps scales by old/new.
    """
    old_data: int
    new_data: int
    accum_steps: int

    @classmethod
    def plan(cls, old_data: int, surviving_hosts: int, hosts_per_data: int = 1,
             base_accum: int = 1) -> "ElasticPlan":
        import math
        new_data = max(1, surviving_hosts // hosts_per_data)
        # keep global batch constant: accum x data >= const (ceil)
        accum = max(1, math.ceil(base_accum * old_data / new_data))
        return cls(old_data=old_data, new_data=new_data, accum_steps=accum)


def run_with_retries(step_fn: Callable, max_retries: int = 2,
                     detector: StragglerDetector | None = None,
                     step_id: int = 0):
    """Redundant-dispatch wrapper: re-runs a straggling/failed step.

    Deterministic step functions make re-execution safe (same batch -> same
    grads); this is the single-controller analogue of backup tasks.
    """
    last_exc = None
    for attempt in range(max_retries + 1):
        t0 = time.perf_counter()
        try:
            out = step_fn()
        except Exception as e:  # device failure surfaces as an exception
            last_exc = e
            continue
        elapsed = time.perf_counter() - t0
        if detector is not None and detector.observe(step_id, elapsed) \
                and attempt < max_retries:
            continue                      # straggler: re-dispatch
        return out, attempt
    raise RuntimeError(f"step {step_id} failed after {max_retries + 1} "
                       f"attempts") from last_exc
