"""Importing this module runs torch on one thread in the importing process.

The port's CPU tests run under pytest-xdist, several workers on a few cores,
and torch's intra-op pool starts one thread a core in every worker: the
threads then outnumber the cores many times over and wait on one another.
On 8 cores, five workers over the ten slowest port test files took 1722 s
summed (471 s wall) with torch's default pool and 880 s (273 s) with one
thread a worker.  Alone, a file takes as long on one thread as on eight
(``test_torch_serve_scheduler.py``: 62 s each way): the models are SMOKE-sized.
Every ``test_torch_*.py`` that runs on the CPU imports this module.
"""
import torch

torch.set_num_threads(1)
