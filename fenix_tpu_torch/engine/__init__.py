"""Query engine: device cache, residency plan, executor, wire dispatch."""

from fenix_tpu_torch.engine import executor, service, session

__all__ = ["executor", "service", "session"]
