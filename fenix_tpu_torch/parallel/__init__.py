"""Multi-device execution: meshes of devices in one process
(``mesh.py``), the row-sharded searches over them (``search.py``) and
repartitioned tables, the host half of ``fenix_tpu/parallel``
(``distributed.py``)."""
