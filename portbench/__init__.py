"""The benchmark of pulseportraiture_tpu_torch, the PyTorch/CUDA port.

``run.py`` is the one command.  Everything that belongs to one model
configuration, traffic mix, cell or per-layer metric sits in a file of its
own under ``configs/``, ``traffic/``, ``limits/`` and ``metrics/``, found
by the name ``BENCHMARK.json`` gives it.  The yardstick (pool generation,
the plain reference, the comparison that decides ``correct``, the trace
reduction and the kernel bounds) lives here too, so that a change to the
program cannot move it.  Nothing here imports JAX or the JAX package.
"""
