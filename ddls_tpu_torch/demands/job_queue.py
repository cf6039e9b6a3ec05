"""Capacity-bounded job queue (reference: ddls/environments/cluster/job_queue.py:8).

Port: a copy of ``ddls_tpu/demands/job_queue.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

from collections import OrderedDict

from ddls_tpu_torch.demands.job import Job


class JobQueue:
    def __init__(self, queue_capacity: int = 10):
        self.queue_capacity = queue_capacity
        self.jobs: "OrderedDict[int, Job]" = OrderedDict()

    def can_fit(self, job: Job) -> bool:
        return len(self.jobs) < self.queue_capacity

    def add(self, job: Job) -> None:
        if not self.can_fit(job):
            raise RuntimeError(
                f"job queue at capacity ({self.queue_capacity}); cannot add "
                f"job {job.job_id}")
        self.jobs[job.job_id] = job

    def remove(self, job: Job) -> None:
        del self.jobs[job.job_id]

    def __len__(self) -> int:
        return len(self.jobs)

    def __contains__(self, job_id) -> bool:
        return job_id in self.jobs
