"""Deterministic fault injection for the streaming sweep executor (the
port's own copy of the reference ``repro.runtime.fault_injection``).

Fault tolerance that is only exercised by production outages is fault
tolerance that does not work.  This module provides the executor-side
hook :class:`FaultInjector`: a callable the streaming executor
(:func:`repro_torch.core.stream.stream_grid`, ``fault_injector=``) invokes
immediately before every chunk dispatch, which *deterministically*
injects the failure classes the recovery machinery must survive:

* **raise-on-chunk-k** (``fail_chunks=``) — a
  :class:`TransientDeviceError` fired once when the dispatch cursor
  reaches chunk ``k``; exercises the bounded in-place retry path.
* **seeded transient errors** (``transient_rate=`` + ``seed=``) — a
  per-dispatch Bernoulli draw keyed by ``(seed, flat start)``, so the
  same faults fire at the same chunks on every run (and *only once* per
  chunk, so bounded retries always converge); exercises retry under
  sustained fault rates.
* **artificial stragglers** (``straggle=``) — injected dispatch delays
  that the executor's straggler detector
  (:class:`repro_torch.runtime.fault_tolerance.StragglerDetector`) must flag.
* **device loss** (``lose_device=``) — a :class:`DeviceLostError` naming
  a device shard; exercises the elastic replan path
  (:func:`repro_torch.runtime.elastic.drop_worker` shrink + snapshot
  restore), and on one device a restart from the last snapshot.
* **SIGKILL** (``kill_at=``) — the injector kills its own process with
  an uncatchable signal, simulating preemption of a subprocess worker;
  exercises checkpoint/resume end-to-end (the kill-resume parity tests
  and the ``benchmarks/run.py --smoke`` CI gate).

Every trigger is expressed in *absolute chunk ordinals* (``flat start //
chunk_size``), which are stable across retries, pipeline restarts,
elastic replans and checkpoint resumes — determinism is what makes the
recovery paths assertable in CI rather than observable in production.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Mapping, Optional


class TransientDeviceError(RuntimeError):
    """A failure worth retrying: transient device/dispatch error."""


class DeviceLostError(RuntimeError):
    """A device shard died; the executor must replan elastically."""

    def __init__(self, message: str = "device lost", device_index: int = 0):
        super().__init__(message)
        self.device_index = device_index


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative description of the faults to inject (all optional).

    Chunk triggers (``fail_chunks``, ``straggle``, ``lose_device``,
    ``kill_at``) fire **once**, at the first dispatch whose chunk
    ordinal reaches the trigger — with scan fusion or pmap sharding one
    dispatch covers several chunks, so "reaches" is ``>=``, never
    ``==``.
    """

    #: Chunk ordinals at which to raise :class:`TransientDeviceError`
    #: once each (raise-on-chunk-k).
    fail_chunks: tuple[int, ...] = ()
    #: Per-dispatch probability of a seeded transient error.
    transient_rate: float = 0.0
    #: Seed for the transient draws (keyed with the dispatch flat start).
    seed: int = 0
    #: Cap on rate-injected transient errors (None = unbounded).
    max_transient: Optional[int] = None
    #: chunk ordinal -> extra seconds of injected dispatch latency.
    straggle: Optional[Mapping[int, float]] = None
    #: (chunk ordinal, device index): raise :class:`DeviceLostError`.
    lose_device: Optional[tuple[int, int]] = None
    #: Chunk ordinal at which to SIGKILL the current process.
    kill_at: Optional[int] = None


class FaultInjector:
    """Callable executor hook injecting the faults of a :class:`FaultPlan`.

    The executor calls ``injector(chunk_ordinal, flat_start)`` before
    each dispatch.  ``injected`` counts what actually fired (for test
    assertions): ``{"transient": n, "device_lost": n, "straggle": n,
    "kill": n}``.
    """

    def __init__(self, plan: FaultPlan = FaultPlan()):
        self.plan = plan
        self.injected = {"transient": 0, "device_lost": 0,
                         "straggle": 0, "kill": 0}
        self._fired: set = set()

    def _once(self, kind: str, trigger) -> bool:
        """True the first time the cursor reaches ``trigger``."""
        key = (kind, trigger)
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    def __call__(self, chunk_ordinal: int, flat_start: int) -> None:
        plan = self.plan
        if plan.kill_at is not None and chunk_ordinal >= plan.kill_at \
                and self._once("kill", plan.kill_at):
            self.injected["kill"] += 1
            os.kill(os.getpid(), signal.SIGKILL)   # pragma: no cover
        if plan.lose_device is not None \
                and chunk_ordinal >= plan.lose_device[0] \
                and self._once("lost", plan.lose_device[0]):
            self.injected["device_lost"] += 1
            raise DeviceLostError(
                f"injected device loss at chunk {chunk_ordinal}",
                device_index=plan.lose_device[1])
        if plan.straggle:
            for trig, delay_s in plan.straggle.items():
                if chunk_ordinal >= trig and self._once("slow", trig):
                    self.injected["straggle"] += 1
                    time.sleep(delay_s)
        for trig in plan.fail_chunks:
            if chunk_ordinal >= trig and self._once("fail", trig):
                self.injected["transient"] += 1
                raise TransientDeviceError(
                    f"injected transient fault at chunk {chunk_ordinal}")
        if plan.transient_rate > 0.0 and ("rate", flat_start) not in \
                self._fired:
            import numpy as np
            draw = np.random.default_rng(
                (plan.seed, flat_start)).random()
            if draw < plan.transient_rate and (
                    plan.max_transient is None
                    or self.injected["transient"] < plan.max_transient):
                # Fail each dispatch at most once so bounded retries
                # always converge at any injection rate.
                self._fired.add(("rate", flat_start))
                self.injected["transient"] += 1
                raise TransientDeviceError(
                    f"injected seeded transient fault at chunk "
                    f"{chunk_ordinal} (rate {plan.transient_rate})")
