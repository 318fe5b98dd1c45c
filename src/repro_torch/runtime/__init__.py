"""Runtime of the streaming executor: deterministic fault injection and
the retry/straggler policy (copies the port owns of the reference's
``repro.runtime.fault_injection`` and ``fault_tolerance``)."""

from .fault_injection import (DeviceLostError, FaultInjector,  # noqa: F401
                              FaultPlan, TransientDeviceError)
from .fault_tolerance import (FaultToleranceController, FTConfig,  # noqa: F401
                              RetryPolicy, StragglerDetector, WorkerState)
