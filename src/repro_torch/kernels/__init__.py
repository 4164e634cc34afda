"""Hand-written CUDA kernels for the port (sources under ``csrc/``).

Importing this package builds nothing: a kernel is compiled with ``nvcc`` the
first time a CUDA tensor reaches its wrapper (or by ``_build.build_all``).
"""
