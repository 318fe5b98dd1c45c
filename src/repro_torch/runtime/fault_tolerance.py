"""Fault tolerance: heartbeats, failure detection, straggler mitigation
(the port's own copy of the reference ``repro.runtime.fault_tolerance``).

At thousand-node scale the relevant failures are: a worker dies (hardware,
preemption), a worker *slows down* (thermal throttle, ECC storms — the
straggler problem), or the fabric partitions.  The controller below
implements the standard production loop:

    heartbeat -> detect (miss-count / deadline) -> decide
        dead worker      -> restart job from last checkpoint on the
                            surviving + spare workers (elastic reshape)
        straggler        -> log, then evict after ``straggler_patience``
                            consecutive slow steps (checkpoint-restart
                            without it); synchronous SPMD means one slow
                            chip gates the step, so eviction beats waiting.

Everything is deterministic and clock-injectable so the unit tests can
simulate node loss and slow nodes without wall-clock sleeps.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry/backoff policy of the streaming sweep executor.

    Two failure scopes, two budgets:

    * ``max_retries`` — in-place retries of a single chunk dispatch
      (the fault was raised *before* the device consumed the donated
      carry, so the step can simply run again);
    * ``max_restarts`` — full pipeline restarts from the last
      consistent snapshot (the carry may be gone: device loss, errors
      raised mid-execution), re-issuing only the chunk ranges dispatched
      since that snapshot.

    Backoff doubles from ``backoff_s`` up to ``backoff_max_s`` per
    consecutive failure.  ``step_timeout_s`` flags (accounting, not
    abort — a dispatch cannot be cancelled mid-flight)
    dispatches exceeding the deadline; ``straggler_factor`` /
    ``straggler_window`` parameterize the :class:`StragglerDetector`
    the executor runs over dispatch durations.
    """

    max_retries: int = 3
    max_restarts: int = 2
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    step_timeout_s: Optional[float] = None
    straggler_factor: float = 4.0
    straggler_window: int = 32


class StragglerDetector:
    """Single-dispatch-stream adaptation of the controller's straggler
    scan: flags dispatch durations far above the running median.

    The controller above compares workers against each other; the
    streaming executor has one synchronous dispatch stream, so the
    baseline is the rolling median of recent step times instead.
    ``record`` returns True when the duration exceeds ``factor`` times
    the median of the last ``window`` steps (after ``warmup`` samples).
    """

    def __init__(self, factor: float = 4.0, window: int = 32,
                 warmup: int = 3):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self._times: list[float] = []

    def record(self, duration_s: float) -> bool:
        flagged = (len(self._times) >= self.warmup
                   and duration_s > self.factor
                   * statistics.median(self._times))
        self._times.append(duration_s)
        if len(self._times) > self.window:
            self._times.pop(0)
        return flagged


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float = 0.0
    step_times: list[float] = dataclasses.field(default_factory=list)
    slow_streak: int = 0
    alive: bool = True


@dataclasses.dataclass
class FTConfig:
    heartbeat_interval_s: float = 10.0
    missed_heartbeats_fatal: int = 3
    straggler_factor: float = 1.5     # step_time > factor * median
    straggler_patience: int = 5       # consecutive slow steps before evict
    window: int = 20                  # step-time history window


class FaultToleranceController:
    """Tracks worker health; emits restart/evict decisions."""

    def __init__(self, num_workers: int, cfg: FTConfig = FTConfig(),
                 clock: Callable[[], float] | None = None):
        self.cfg = cfg
        self._clock = clock or (lambda: 0.0)
        self.workers = {i: WorkerState(i) for i in range(num_workers)}
        self.events: list[dict] = []

    # ---- ingest ----
    def heartbeat(self, worker_id: int, now: float | None = None):
        w = self.workers[worker_id]
        w.last_heartbeat = self._clock() if now is None else now

    def report_step(self, worker_id: int, step: int, duration_s: float):
        w = self.workers[worker_id]
        w.step_times.append(duration_s)
        if len(w.step_times) > self.cfg.window:
            w.step_times.pop(0)

    # ---- detect ----
    def dead_workers(self, now: float) -> list[int]:
        deadline = (self.cfg.heartbeat_interval_s
                    * self.cfg.missed_heartbeats_fatal)
        return [w.worker_id for w in self.workers.values()
                if w.alive and now - w.last_heartbeat > deadline]

    def straggler_scan(self) -> list[int]:
        """Flag workers whose recent step time exceeds factor x median."""
        alive = [w for w in self.workers.values() if w.alive
                 and w.step_times]
        if len(alive) < 3:
            return []
        med = statistics.median(w.step_times[-1] for w in alive)
        flagged = []
        for w in alive:
            if w.step_times[-1] > self.cfg.straggler_factor * med:
                w.slow_streak += 1
                if w.slow_streak >= self.cfg.straggler_patience:
                    flagged.append(w.worker_id)
            else:
                w.slow_streak = 0
        return flagged

    # ---- decide ----
    def tick(self, now: float) -> Optional[dict]:
        """One control-loop iteration.  Returns a decision event or None."""
        dead = self.dead_workers(now)
        if dead:
            for wid in dead:
                self.workers[wid].alive = False
            ev = {"kind": "restart_from_checkpoint", "lost": dead,
                  "survivors": self.alive_count(), "at": now}
            self.events.append(ev)
            return ev
        slow = self.straggler_scan()
        if slow:
            for wid in slow:
                self.workers[wid].alive = False
            ev = {"kind": "evict_stragglers", "evicted": slow,
                  "survivors": self.alive_count(), "at": now}
            self.events.append(ev)
            return ev
        return None

    def alive_count(self) -> int:
        return sum(1 for w in self.workers.values() if w.alive)
