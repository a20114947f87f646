"""Sharded tables: the host half of ``fenix_tpu/parallel`` (repartitioned
names). The device meshes wait for ROADMAP queue 1 item 10."""
