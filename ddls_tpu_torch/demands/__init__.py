"""Jobs and their generator (copy of ``ddls_tpu/demands``)."""
from ddls_tpu_torch.demands.job import Job
from ddls_tpu_torch.demands.job_queue import JobQueue
from ddls_tpu_torch.demands.jobs_generator import JobsGenerator

__all__ = ["Job", "JobsGenerator", "JobQueue"]
