"""The failure model of the port (counterpart of ``tpuframe/resilience``):

  * :mod:`~tpuframe_torch.resilience.policy`: retry with backoff and
    decorrelated jitter for transient I/O, under every storage operation;
  * :mod:`~tpuframe_torch.resilience.faults`: ``TPUFRAME_FAULTS``, fault
    injection at named seams, so every recovery path is testable on the
    CPU;
  * :mod:`~tpuframe_torch.resilience.preempt`: the preemption contract.
    SIGTERM/SIGINT set a flag, the trainer checkpoints at the next step
    boundary and exits with rc 14 so that a supervisor resumes the run.

Exit codes: 0 clean completion, 14 preempted with the final checkpoint
committed (resume me), 42 injected crash (fault kind ``crash``).
"""

from tpuframe_torch.resilience.policy import (  # noqa: F401
    RetryPolicy,
    is_retryable,
    retrying,
)
from tpuframe_torch.resilience import faults  # noqa: F401
from tpuframe_torch.resilience.preempt import (  # noqa: F401
    RC_PREEMPTED,
    PreemptionGuard,
)
