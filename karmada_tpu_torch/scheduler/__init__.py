"""The port's scheduler: the cycle (core.schedule_items over the chunked
pipeline), the incremental steady state, and the store-watching service
(service.Scheduler over queue.SchedulingQueue)."""

from __future__ import annotations

from karmada_tpu_torch.scheduler.queue import (  # noqa: F401
    QueuedBindingInfo,
    SchedulingQueue,
)
from karmada_tpu_torch.scheduler.service import Scheduler  # noqa: F401
