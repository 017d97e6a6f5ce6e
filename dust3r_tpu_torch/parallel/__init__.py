"""Parallelism over devices: processes and their group (`distributed.py`),
the axes of `--mesh` (`mesh.py`: device lists for the data axis, the
parameter shardings of the fsdp and model axes in training).

Counterpart of `dust3r_tpu/parallel/`.
"""
