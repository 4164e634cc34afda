"""PyTorch / CUDA port of the ``repro`` package ("Parallel Scan on Ascend AI
Accelerators"), written for one NVIDIA H100.

The layout mirrors ``src/repro/`` module for module, so each port module sits
where its JAX counterpart does.  Plain tensor code is PyTorch; every Pallas
kernel on the ported path is a hand-written CUDA C++ kernel for ``sm_90a``
under ``kernels/csrc/``, built with ``nvcc`` at first use.  On CPU tensors
each kernel wrapper runs the kernel's plain PyTorch version instead.

This package imports neither JAX nor the ``repro`` package.
"""
__version__ = "0.1.0"
