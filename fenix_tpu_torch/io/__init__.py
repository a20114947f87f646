"""Storage + ingest layer: the Arrow IPC catalog (``arrow``, ``table``,
``locks``, copied from ``fenix_tpu/io``) and the Arrow ⇄ device-tensor
bridge (``ingest``)."""

from fenix_tpu_torch.io import arrow, ingest, table

__all__ = ["arrow", "ingest", "table"]
