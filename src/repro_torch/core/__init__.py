# The paper's primary contribution: preemption-safe accelerated data mining.
# - kmeans / dbscan: the two algorithms, kernel-backed, as cancellable and
#   resumable host loops;
# - jobs: WorkManager-analogue persistent job store;
# - cancellation: the abort-flag protocol behind the RW lock.

from repro_torch.core.cancellation import (
    CancellationToken,
    CancelReason,
    JobCancelled,
    cancel_after,
)
from repro_torch.core.jobs import Job, JobState, JobStore

__all__ = [
    "CancellationToken",
    "CancelReason",
    "JobCancelled",
    "cancel_after",
    "Job",
    "JobState",
    "JobStore",
]
