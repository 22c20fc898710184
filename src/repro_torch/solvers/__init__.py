"""Sparse iterative solvers built on the GHOST building blocks (paper C7)."""
from repro_torch.solvers.operator import (GhostOperator, MatrixFreeOperator,
                                          make_operator)
from repro_torch.solvers.block import BlockCGState, BlockMinresState
from repro_torch.solvers.cg import (CGResult, CGState, PCGState,
                                    PrecondCGState, cg,
                                    cg_finalize, cg_init, cg_step,
                                    pipelined_cg, pipelined_cg_finalize,
                                    pipelined_cg_init, pipelined_cg_step)
from repro_torch.solvers.minres import (MinresResult, MinresState,
                                        PrecondMinresState, minres,
                                        minres_finalize, minres_init,
                                        minres_step)
from repro_torch.solvers.precond import (BlockJacobiPreconditioner,
                                         ChebyshevPreconditioner,
                                         extract_block_diag,
                                         factorize_blocks,
                                         make_preconditioner,
                                         parse_precond_spec)
from repro_torch.solvers.stepper import merge_columns, run_chunk
from repro_torch.solvers.lanczos import lanczos, lanczos_extrema
from repro_torch.solvers.kpm import kpm_dos_moments, jackson_kernel
from repro_torch.solvers.chebfd import chebfd

__all__ = [
    "GhostOperator", "MatrixFreeOperator", "make_operator",
    "BlockCGState", "BlockMinresState",
    "CGResult", "CGState", "PrecondCGState", "PCGState", "cg", "cg_init",
    "cg_step", "cg_finalize", "pipelined_cg", "pipelined_cg_init",
    "pipelined_cg_step", "pipelined_cg_finalize",
    "MinresResult", "MinresState", "PrecondMinresState", "minres",
    "minres_init", "minres_step", "minres_finalize",
    "merge_columns", "run_chunk",
    "lanczos", "lanczos_extrema",
    "kpm_dos_moments", "jackson_kernel", "chebfd",
    "BlockJacobiPreconditioner", "ChebyshevPreconditioner",
    "extract_block_diag", "factorize_blocks", "make_preconditioner",
    "parse_precond_spec",
]
