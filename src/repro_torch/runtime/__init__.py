"""Runtime of the streaming executor: deterministic fault injection, the
retry/straggler policy and the elastic replan (copies the port owns of
the reference's ``repro.runtime.fault_injection``, ``fault_tolerance``
and ``elastic``)."""

from .elastic import (MeshPlan, drop_worker, replan_mesh,  # noqa: F401
                      rescale_batch)
from .fault_injection import (DeviceLostError, FaultInjector,  # noqa: F401
                              FaultPlan, TransientDeviceError)
from .fault_tolerance import (FaultToleranceController, FTConfig,  # noqa: F401
                              RetryPolicy, StragglerDetector, WorkerState)
