"""GHOST building blocks in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``, module for module: ``matrices``
(generators, Matrix Market IO), ``core`` (SELL-C-sigma storage, the fused
augmented SpM(M)V, device resolution), ``kernels`` (the CUDA kernels and
their plain versions) and ``solvers`` (operators, the resumable CG
steppers).  Entry points run on the card unless the caller asks for the
CPU.  ``interop`` carries the JAX package's arrays across.
"""
