"""Sparse iterative solvers built on the GHOST building blocks (paper C7)."""
from repro_torch.solvers.operator import (GhostOperator, MatrixFreeOperator,
                                          make_operator)
from repro_torch.solvers.cg import (CGResult, CGState, PCGState, cg,
                                    cg_finalize, cg_init, cg_step,
                                    pipelined_cg, pipelined_cg_finalize,
                                    pipelined_cg_init, pipelined_cg_step)
from repro_torch.solvers.stepper import merge_columns, run_chunk

__all__ = [
    "GhostOperator", "MatrixFreeOperator", "make_operator",
    "CGResult", "CGState", "PCGState", "cg", "cg_init",
    "cg_step", "cg_finalize", "pipelined_cg", "pipelined_cg_init",
    "pipelined_cg_step", "pipelined_cg_finalize",
    "merge_columns", "run_chunk",
]
