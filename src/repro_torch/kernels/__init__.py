"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Each kernel's source lives in ``csrc/`` and is built with ``nvcc`` at
first use (``_build.py``); importing this package builds nothing.
"""
