"""The benchmark of ``rife_tpu_torch`` on one NVIDIA H100.

Run from the root of a checkout:
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Everything here belongs to the benchmark: the traffic, the model graphs and
weights it writes, the plain reference that decides ``correct``, the work
counts and the trace readers.  Of the program it imports ``rife_tpu_torch``
alone, and never the JAX package beside it.
"""
