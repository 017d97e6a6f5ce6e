"""The benchmark of dust3r_tpu_torch on the NVIDIA H100 (`python3 -m
portbench.run`); see README.md. Importing it loads nothing of the program."""
