"""Data parallelism over devices: processes and their group
(`distributed.py`), device lists (`mesh.py`).

Counterpart of `dust3r_tpu/parallel/`. The data axis only: the `fsdp` and
`model` axes of `--mesh` raise (ROADMAP.md A10b).
"""
