"""Runtime of the streaming executor and the sweep service: deterministic
fault injection, the retry/straggler policy, the elastic replan,
multi-tenant fair admission control, the framed-socket transport of the
networked sweep service, and the multi-process worker pool (chunk-range
leasing over a shared spool, one card a worker).  The port's own copies
of the reference package's ``runtime`` modules."""

from .admission import (AdmissionQueue, BackpressureError,  # noqa: F401
                        Deadline, TenantPolicy)
from .elastic import (MeshPlan, drop_worker, replan_mesh,  # noqa: F401
                      rescale_batch)
from .fault_injection import (DeviceLostError, FaultInjector,  # noqa: F401
                              FaultPlan, TransientDeviceError)
from .fault_tolerance import (FaultToleranceController, FTConfig,  # noqa: F401
                              RetryPolicy, StragglerDetector, WorkerState)
from .transport import AuthenticationError, SweepServer  # noqa: F401
from .workers import (JobHandle, LeaseBoard, WorkerPool,  # noqa: F401
                      dispatch_job)
