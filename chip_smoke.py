#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` (one
``nvcc`` per source, started together) and drives the port's paths on
the card, holding every kernel against its plain PyTorch version:

1. environment: card name and power limit, CUDA and nvcc versions;
2. build: seconds and the compiler's register/shared-memory/spill report
   (no B6 instance may spill), and the instructions per state update in
   B6's hot loop (``cuobjdump -sass``);
3. B1 (fused SpMV) against plain over a grid of chunk heights, sorting
   windows, store/compute dtypes, block widths and fusion flags;
4. B2 (tsmttsm, with and without Kahan) and B3 (tsmm, with and without
   the output operand) against their plain versions computed in float64,
   over row counts, widths, dtypes and alpha/beta pairs (B3 also at each
   of its template widths m = k = 1 ... 64), and B2 and B3 on views off a
   16-byte boundary (B2's stages then fill by plain loads, B3's value by
   value, bit-equal to aligned copies);
5. the paper's case study (MATPDE, CG) with B1's launch count;
6. slice 1's main path at full width: column CG (``block=False``, four
   independent right-hand sides) on laplace3d(160) (4,096,000 rows) in
   float64 and with bfloat16 storage, plus a chunked float64 solve that
   must equal the monolithic one bit for bit;
7. the quickstart SpMMV (shift, axpby, all dots) at full width;
8. slice 2's main path at full width: block CG (``block=True``, BCGrQ,
   width 16) on the same float64 matrix, with the launches of B1, B2 and
   B3 per iteration, the column-CG sweep count on the same right-hand
   side, and a chunked block solve equal to the monolithic one;
9. block MINRES at full width;
10. eigensolvers: Lanczos extrema of laplace3d(160), ChebFD on a
    laplace3d window with closed-form eigenvalues, KPM moments at full
    width;
11. timing of every kernel, its plain version and one PyTorch call that
    computes the same function, beside the memory-bandwidth bound (B1 at
    b = 1, 4 and 16), and the time split of one full-width block-CG
    iteration, with the eigensolver at its Gram against
    ``torch.linalg.eigh``;
12. B4 (block-diagonal matmul, the block-Jacobi apply) and B5 (fused
    axpby + dots) against their plain versions computed in float64, over
    block sizes, widths, block counts, row counts, dtypes, coefficients
    and dot flags, each held to a stated error bound; then the port's
    own eigensolver (``herm_eig``) against ``torch.linalg.eigh`` over
    dtypes, orders 1–64 and Gram, rank-deficient and repeated-eigenvalue
    matrices (eigenvalues, ||AU - UW||, ||U^H U - I|| within stated
    bounds), as a batch, and with no synchronising call;
13. slice 4's main path at full width: block-Jacobi preconditioned CG
    (``M=make_preconditioner("block_jacobi", ...)``, bs = C = 32) on
    anisotropic_laplace2d(2048, eps=1e-2) (4,194,304 rows, sigma=1),
    float64, four right-hand sides, with the host set-up time, launches of
    B1 and B4, the true residual per column, a chunked solve equal to the
    monolithic one, and plain CG on the same right-hand sides beside it;
    the true residual checked again through B5 (its only path: no solver
    calls it, in either package);
13b. slice 15, complex values on the card: B1 (complex64 and complex128,
    b = 1, 4, 16, C = 8 and 32, every fusion flag with complex alpha,
    beta, gamma, delta and eta, and a real x), B2 (conj on and off, with
    and without Kahan, m, k up to 64), B3 (complex and real X, and its
    template widths), B4 (bs 8 and 32, complex and real x) and B5
    (slice 16: complex a, b, every width up to 256, a real x) against
    their plain versions, each within a stated bound (the real kernels'
    error model per part of the complex sum);
13c. complex Hermitian solves through the normal entry points on the
    phased matrices (U(1) phases on the off-diagonals, ``phased``): on
    laplace3d(160), column CG (b = 4) in complex128 at tol 1e-8 and
    complex64 at 1e-5, block CG and block MINRES at width 16, Lanczos
    (k = 30, reorthogonalised) against an ``impl="ref"`` operator within
    1e-10; on anisotropic_laplace2d(1024), block-Jacobi PCG and PMINRES
    in complex128; the engine (one shard a card where there are several,
    else 4 card shards): a matvec within 1e-12 of max|y| of the
    one-device SpMV, then CG through ``DistOperator``.  Every column's
    true relative residual at most 10 tol (the plain SpMV in complex128),
    iterations and ms/iter beside the real matrix' iterations, and each
    kernel's launches equal to what the recurrence makes.  Slice 16:
    pipelined CG in at most plain CG's count + 2; ChebFD's lowest Ritz
    value within 1e-8 relative of lambda_min from a 200-step Lanczos;
    KPM's mu_2, fused and unfused, within four float32 roundings of
    2 ||A_s v||^2 - ||v||^2 through ``impl="ref"``; the complex CG
    residual through B5's complex variant;
13d. B1–B5 in complex128 at the main shapes (B1 b = 1, 4, 16 on the
    phased laplace3d(160); B2 Kahan and B3 with and without W at
    4,096,000 x 16; B4 131,072 blocks of 32, b = 4; B5 4,096,000 x 4, and
    in complex64), each first held against its plain
    version (B1 within 1e-12, B2–B4 within the grid's bound): kernel,
    plain version, one PyTorch call (a complex128 sparse CSR product,
    ``V.mH @ W``, ``addmm``, ``bmm``) and the bound at the data sheet's
    3.35 TB/s (and, as a second figure, at the measured 3032.3 GB/s), on
    ``[complex]`` lines;
14. block-Jacobi preconditioned MINRES on the same matrix, and
    Chebyshev-preconditioned CG on anisotropic_laplace2d(1024);
15. timing of B4 and B5 at the main shapes (B5 in float64 and float32,
    with its device time from the profiler and its host syncs a call),
    and the time split of one preconditioned CG iteration;
15b. ``run_chunk``, which reads the stopping test one iteration late,
    against a loop that reads it every iteration, on column CG, PCG,
    block CG and block MINRES at full width: equal states, ms per
    iteration in turns, synchronising calls per iteration (0 required of
    the block steppers' late read), and a profiler split of the
    iterations by kind of kernel with the time the card sat idle; then
    the host syncs of the calls that hand a coefficient to a kernel (B5
    with Python numbers, real and complex; B1 with a Python-float gamma;
    a ChebFD filter step; a KPM moment step), 0 required of each;
15c. slice 6's main path at full width: the continuous-batching
    ``SolverService`` over a ``MatrixRegistry`` holding laplace3d(160) and
    anisotropic_laplace2d(2048) (prebuilt): 32 mixed CG/MINRES requests
    against one solve per request (requests/s, p50/p99 latency), 4
    stragglers and 24 easy requests under FIFO and bucketed admission
    (p50/p99 per class), block requests in two waves (one warm restart,
    B2/B3), block-Jacobi requests on anisotropic_laplace2d(1024) (B4),
    the true residual of every converged request, the card against the
    CPU under a virtual clock, and a drain's time by part (chunk, refill
    upload/init/merge, retire finalize/download) with the service's
    per-iteration estimate beside the measured one;
15d. the device pool's bandwidths (``runtime/devicepool.py``'s table): a
    2 GiB float64 copy on the card and on the host, pinned copies between
    them, and (with two cards or more) a 2 GiB copy from ``cuda:0`` to
    ``cuda:1``, beside the card's name and power limit, the card count
    and the host CPU model;
15e. slice 7's paper workload, ``mlgeer_like`` (``configs/ghost_spmv.py``:
    n = 1,504,002, band 40, density 0.9, b = 4, f64): the
    ``HeterogeneousEngine``'s distributed SpMV on 1 and 4 card shards and
    on the host plus the card (modeled weights), each against the
    one-device plain SpMV (as is the one-device B1, also timed at the JAX
    package's chunk-width rounding w_align 8), overlap against no overlap
    and the double-buffered chain bit for bit, B1's launches, ms per
    matvec, halo words, build seconds, B1 on a remote (rectangular) part
    against the bytes it needs, and the host + card split by shard and
    copy;
15f. column CG through ``DistOperator`` on laplace3d(160) (phase 6's
    system) on 4 card shards and on the host plus the card: iterations,
    ms/iter beside phase 6, the true residual per column, B1's launches;
15g. the rebalance loop on the host + card engine: three steps on
    measured per-shard times (CUDA events on the card, the host clock on
    the host), each generation held against the one-device SpMV;
15h. engine-backed serving: the 4-shard engine in a ``MatrixRegistry``,
    CG requests with and without ``chebyshev:3``, true residuals;
15i. slice 14: the engine with one shard a card.  The card count, peer
    access between every pair and ``nvidia-smi topo -m``; with fewer than
    two cards one line that says the phase did not run.  Else
    ``mlgeer_like`` with one shard a card (phase 15e's 4-shard matrix
    moved card by card where there are 4 cards): y and the dots bit-equal
    to the same shards on one card and within 1e-12 of the one-device
    plain SpMV, overlap against no overlap and the double-buffered chain
    bit for bit, B1's launches, ms a matvec in turns against one card,
    each card's stages timed alone, the copies the profiler saw beside B1
    on each card, and the bytes a matvec moves between cards (halo, and
    ``DistOperator``'s split and join); the host + every card plan within
    1e-12, timed; CG through ``DistOperator`` on laplace3d(160) with the
    iterations of the same shards on one card, true residuals, B1's
    launches;
16. B6 (the selective scan) against its plain version computed in
    float64, over batch, sequence length, d_inner and state size, with dt
    from 0 to large and A <= 0, each output held to a stated error bound
    (the earlier phases' matrices are freed first);
16b. B6's exponential (``ex2.approx.ftz.f32``) on every finite float32
    argument <= 0 against exp2 in float64, held to the error
    ``error_bound`` charges for it;
17. slice 8a's main path at full width: ``forward`` (the serving
    prefill) of jamba-1.5-large at its published widths, cut to one
    period of 8 layers (7 Mamba, attention at index 4) with a dense
    SwiGLU FFN in every slot instead of MoE (one period with its four MoE
    FFNs needs 90.5 GB), bfloat16, weights from a seed, B = 4, S = 4096:
    B6 launches (one per Mamba layer), finite logits, tokens/s and the
    split of one forward timed with CUDA events;
18. ``launch.serve.generate`` on that model: a 16-token prompt and 32
    greedy tokens, ms per token;
19. the same model in float32, B = 1: ``forward`` (through B6) against 64
    ``decode_step`` calls (plain PyTorch) within a stated tolerance;
20. the registered SMOKE jamba (MoE, 4 experts): ``forward`` and decode
    on the card against the port's CPU run of the same weights;
21. timing of B6 at the main shape beside its plain version and its
    bound, on the grid's inputs and on the model's own, and B6 back to
    back under the prefill split's protocol and this phase's, on an idle
    card and right after bf16 products, with the SM clock and throttle
    reasons sampled during each window (why B6 is slower in the split);
22. slice 8b's main paths, one architecture after the other (each freed
    before the next): llama3.2-3b, qwen2.5-3b, minitron-8b,
    mistral-nemo-12b and qwen2-vl-7b whole, grok-1 (one of 64 layers, all
    8 experts) and llama4-maverick (one period of 2 of 48 layers, all 128
    experts), whisper-medium (24 + 24 layers, 1500 encoder frames) and
    xlstm-1.3b (48 layers; the chunkwise mLSTM timed beside the recurrent
    one, and whether the recurrence is bound by its state traffic or its
    launches), at their published widths in bf16 with weights from a
    seed: tokens/s of one prefill (B 4, S 4096; whisper 187 decoder
    tokens; xLSTM 1024) timed with CUDA events after a warm-up,
    ``generate`` (16-token prompt, 32 greedy tokens, B 4) in ms a decode
    step, parameters (all and active), peak memory, finite logits and
    tokens in the vocabulary; each in float32 at one period, B 1: decode
    against forward within 2e-3 of max |logit| (xLSTM 5e-3; MoE models
    with no token dropped and routers x 20); each at its SMOKE size on the card against
    the port's CPU run of the same weights within 1e-4.  No kernel of the
    port is on these paths;
23. slice 11's main path: training.  llama3.2-3b at its published widths
    (all 28 layers, 3.213 G parameters) in bf16 with float32 AdamW state
    and per-period remat, B 2 x S 2048 from ``SyntheticLM(seed=0)``: 2
    untimed and 8 timed ``Trainer.train_step`` calls (CUDA events: ms a
    step, tokens/s, forward+backward against clip+update), peak memory,
    loss and gnorm at the first and last step, finite, gnorm > 0, the
    weights moved; its gradients in float32 at 2 layers, B 1 x S 2048, on
    the card against the CPU; every architecture's SMOKE config, one train step on
    the card against the CPU with the same weights and batch (loss and
    every gradient leaf); kill and restart on the card (SMOKE llama3.2-3b,
    float32): a run of 6 steps saving at step 3, a fresh trainer
    resuming there, its state equal to the checkpoint bit for bit, its
    first loss equal to the first run's bit for bit and the next two
    within 1e-4.  No kernel of the port is on the training path;
24. slice 12: the dry run.  The structural pass of all 32 (architecture
    x shape) cells on the single-pod mesh (``launch.dryrun.run_cell``:
    the model on ``meta``, per-device argument bytes, the analytic cost
    with the H100 table) and the measured pass of six cells at their
    published widths, one period each at one device's share of the pod
    (llama3.2-3b train_4k, prefill_32k and decode_32k; grok-1
    prefill_32k, MoE; xlstm-1.3b long_500k, recurrent; jamba-1.5-large
    train_4k, which must be recorded as not fitting the card): median ms,
    peak memory, ``compute_fraction`` in (0, 1.05] and peak within the
    card's memory, ``measured_fraction`` printed (above 1.05 it shows an
    overcount in the analytic bytes model), one more run of the train and
    prefill cells under the profiler (the card's idle share, device time
    by kind of kernel), and the roofline table.  No kernel of the port is
    on these paths.
25. slice 13: training on a (data, model) mesh of 4 ranks, one process
    a rank (``nccl`` with a card a rank where the machine has 4 cards,
    else ``gloo`` with the ranks sharing the card; the backend, the card
    count and each rank's device printed): (a) ``compressed_psum`` on
    the card, int8 equal to the int32 sum of the quantised inputs and
    within world * scale / 2 of the float64 sum, bf16 within 2^-6 of the
    sum of |x|; (b) the SMOKE qwen2.5-3b and grok-1 in float32 (grok-1
    at capacity factor 8, which drops no token, and at its own 1.25,
    whose drops the mesh must reproduce), 4 steps
    on (2, 2) under each layout against the one-device trainer on the
    card and on the CPU, one checksum of the full parameters on every
    rank after each step, resume on (2, 2) (the restored state bit-equal
    to the checkpoint), save on (2, 2) and resume on (4, 1) and on one
    device; (c) llama3.2-3b at its published widths cut to 2 layers,
    bf16 with float32 AdamW, global batch 4 x S 2048 on (2, 2) ``tp``: ms
    a step (median of 3 after a warm-up), each rank's peak memory, the
    bytes it holds (full parameters and gradient, its AdamW slot shards
    against ``shard_bytes``), a profiler split of one step into
    collectives, compute and idle on rank 0, then a save, two more
    steps, and the same two steps resumed on (4, 1) (the restored state
    bit-equal to the checkpoint; the losses within MESH_BF16_TOL, and a
    control run from fresh weights at least 10x further off).  Every
    rank runs
    every check; a failure in any rank fails the phase.  No kernel of
    the port is on this path.

Each phase prints its seconds.  It prints one JSON line describing every
kernel, then as its last line ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before the last line.  It imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import importlib
import inspect
import json
import os
import pickle
import platform
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs)
from repro_torch.core import SpmvOpts, execution, from_coo  # noqa: E402
from repro_torch.core.spmv import x_rows  # noqa: E402
from repro_torch.core.distributed import (Staging, fused_epilogue,  # noqa: E402
                                          halo_exchange, halo_pack,
                                          halo_unpack, local_stage,
                                          remote_stage)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_update  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    EXP_FLUSH, EXP_REL, EXP_ULP, exp2_cuda, error_bound as scan_error_bound)
from repro_torch.kernels.ops import (block_jacobi_apply,  # noqa: E402
                                     fused_axpby_dots, herm_eig, mamba_scan,
                                     sellcs_spmv, tsmm, tsmttsm)
from repro_torch.kernels.herm_eig import (  # noqa: E402
    BLOCK as EIG_BLOCK, herm_eig_cuda, wide_order)
from repro_torch.kernels.sellcs_spmv import (chunk_parts,  # noqa: E402
                                             dot_parts, launch_geometry)
from repro_torch.kernels.ref import (block_diag_matmul_ref,  # noqa: E402
                                     fused_axpby_dots_ref, mamba_scan_ref,
                                     sellcs_spmv_ref, tsmm_ref, tsmttsm_ref,
                                     tsmttsm_exact_entries)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.kernels.tsmttsm import summation_depth  # noqa: E402
from repro_torch.kernels import tsmttsm as b2  # noqa: E402
from repro_torch.matrices import (anisotropic_laplace2d,  # noqa: E402
                                  laplace3d, matpde)
from repro_torch.solvers import (cg, cg_finalize, cg_init, cg_step,  # noqa: E402
                                 chebfd, kpm_dos_moments, lanczos,
                                 lanczos_extrema, make_operator,
                                 make_preconditioner, minres,
                                 minres_finalize, minres_init, minres_step)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.runtime import (TERMINAL_STATES,  # noqa: E402
                                 DevicePool, HeterogeneousEngine,
                                 MatrixRegistry, SolverService)
from repro_torch.configs.ghost_spmv import WORKLOADS  # noqa: E402
from repro_torch.matrices import banded_random  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, to_device  # noqa: E402
from repro_torch.interop import to_numpy  # noqa: E402
from repro_torch.train.checkpoint import (flatten,  # noqa: E402
                                          restore_checkpoint)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from repro_torch.configs import SHAPES, dryrun_cells  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import (init_ranks,  # noqa: E402
                                     make_host_mesh, make_mesh)
from repro_torch.launch.mesh import HW as MESH_HW  # noqa: E402
from repro_torch.interop import arrays_from_model, model_from_arrays  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.train.optimizer import compressed_psum  # noqa: E402
from repro_torch.solvers import block  # noqa: E402
cg_mod = importlib.import_module("repro_torch.solvers.cg")
chebfd_mod = importlib.import_module("repro_torch.solvers.chebfd")
kpm_mod = importlib.import_module("repro_torch.solvers.kpm")
from repro_torch.solvers import run_chunk  # noqa: E402
from repro_torch.solvers.lanczos import tridiag_eigh  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), the bound's denominator
HBM_BYTES_PER_S = 3.35e12
KERNEL = "sellcs_spmv"
#: every kernel: its CUDA source and the TPU kernel (file:line) it replaces
KERNELS = {
    "sellcs_spmv": ("src/repro_torch/kernels/csrc/sellcs_spmv.cu",
                    "src/repro/kernels/sellcs_spmv.py:128"),
    "tsmttsm": ("src/repro_torch/kernels/csrc/tsmttsm.cu",
                "src/repro/kernels/tsmttsm.py:90"),
    "tsmm": ("src/repro_torch/kernels/csrc/tsmm.cu",
             "src/repro/kernels/tsmm.py:42"),
    "block_diag_matmul": ("src/repro_torch/kernels/csrc/block_diag.cu",
                          "src/repro/kernels/block_diag.py:50"),
    "fused_axpby_dots": ("src/repro_torch/kernels/csrc/fused_update.cu",
                         "src/repro/kernels/fused_update.py:42"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:57"),
    # the port's own kernel: no TPU kernel; it stands where the JAX
    # package's block Krylov calls jnp.linalg.eigh (torch.linalg.eigh
    # checks its info on the host every call)
    "herm_eig": ("src/repro_torch/kernels/csrc/herm_eig.cu",
                 "none: src/repro/solvers/block.py:95,133 (jnp.linalg.eigh)"),
}
# max |kernel - plain| / max |plain|, by compute dtype
TOL = {torch.float64: {"vec": 1e-12, "dots": 1e-12},
       torch.float32: {"vec": 1e-5, "dots": 1e-6}}
GRID_PAIRS = [(torch.float64, np.float64), (torch.float32, np.float32),
              (torch.bfloat16, np.float32), (torch.float16, np.float32),
              (torch.float32, np.float64)]


#: where the phases run, and the full-width grid (a CPU rehearsal of the
#: control flow may lower them; the card run uses these values)
DEVICE = "cuda"
NX = 160
#: the widest instance of each kernel's narrow design (B2/B3's widths, the
#: eigensolver's m, B4's bs, B6's N); the wide grids start past it
NARROW = 64
#: block width of the block-Krylov main path, and the TSM grid's row counts
WIDTH = 16
TSM_NS = (0, 1, 37, 4109, 1 << 20)
TSM_DIMS = (1, 3, 8, 16, NARROW)
#: (m, k) of B2's cases on views off a 16-byte boundary (the stages then
#: fill by plain loads)
TSM_ODD = ((3, 5), (1, 7), (5, 3), (7, 9))
#: B3's template widths (m = k) that TSM_DIMS leaves out, checked on their
#: own; and B3 on views off a 16-byte boundary (value-by-value loads) at
#: these (m, k)
TSMM_SQUARES = (2, 4, 32)
TSMM_ODD = ((16, 16), (5, 13), (1, 1))
#: B1's timed calls: (width, with CG's <p, Ap> dot) — 1 and 4 as column
#: CG and PCG call it, 16 as block CG calls it (no dot) and with the dot
SPMV_TIMED = ((1, True), (4, True), (WIDTH, False), (WIDTH, True))
#: ChebFD on laplace3d(CHEB_NX): window, degree and sweeps with which the
#: JAX package converges on the CPU (four eigenvalues inside the window)
CHEB_NX, CHEB_TARGET, CHEB_DEGREE, CHEB_SWEEPS = 16, (0.05, 0.25), 150, 4
#: slice 4: the preconditioned main path's grid (anisotropic_laplace2d,
#: eps 1e-2, C=32, sigma=1, so the aligned bs=32 blocks are segments of
#: the strong grid lines, as in the JAX package's benchmarks/table_precond.py),
#: the grid of the Chebyshev-preconditioned solve, and the block size
PRECOND_NX, CHEB_PCG_NX, PRECOND_EPS, PRECOND_C = 2048, 1024, 1e-2, 32
PCG_TOL, PMINRES_TOL, PRECOND_WIDTH = 1e-8, 1e-6, 4
#: B4 and B5 grids
B4_BS = (1, 4, 8, 16, 32, 48, NARROW)
B4_B = (1, 3, 4, 16)
B4_NB = (0, 1, 7, 4096)
B5_NS = (0, 1, 37, 4109, 1 << 20)
#: (bw = 3 and 86: periods of whole rows that a warp does not divide; 256
#: in float64: 128 slots, two lanes a block)
B5_BW = (1, 3, 4, 16, 86, 256)
#: B5 past one thread block's slots (grid.y slot tiles): widths and their
#: row counts, each call made twice and held bit-equal
B5_WIDE_BW, B5_WIDE_NS = (257, 512), (0, 1, 37, 4109)
#: slice 8a: the B6 grid, and the jamba serving path (``lm_config``): its
#: widths ("full": the published ones; "smoke": the registered SMOKE ones,
#: for a CPU rehearsal), prefill batch and length, the serve loop's prompt
#: and output lengths, the float32 decode-vs-forward length and the
#: tolerances of the decode-vs-forward and MoE card-vs-CPU checks
B6_B = (1, 3)
B6_S = (1, 7, 64, 257, 4096)
B6_DI = (1, 8, 100, 16384)
B6_N = (1, 4, 16, NARROW)
#: B6's exponential: float32 arguments per launch, and the stride through
#: their bit patterns (1: every finite argument <= 0; a CPU rehearsal
#: strides)
EXP2_CHUNK, EXP2_STRIDE = 1 << 28, 1
LM_ARCH, LM_WIDTHS, LM_SEED = "jamba_1_5_large_398b", "full", 0
LM_BATCH, LM_SEQ = 4, 4096
SERVE_PROMPT, SERVE_GEN = 16, 32
DECODE_SEQ, DECODE_TOL, MOE_TOL = 64, 2e-3, 1e-4
#: slice 8b: every other architecture of the registry (in its order) at
#: its published widths (``LM_WIDTHS``), one after the other.
#: ``ARCH_PERIODS`` cuts a model to that many periods of its pattern:
#: grok-1 and llama4-maverick with all their experts at published width
#: fit one card as one period (about 13 and 37 GB of bf16 weights); the
#: rest run every layer.
#: Whisper's encoder takes WHISPER_FRAMES frames (its 30 s window) and its
#: decoder WHISPER_FRAMES // dec_len_ratio tokens; xLSTM prefills
#: XLSTM_SEQ tokens; the MoE checks multiply the routers by ROUTER_SCALE.
ARCHS_8B = tuple(a for a in list_archs() if a != LM_ARCH)
ARCH_PERIODS = {"grok_1_314b": 1, "llama4_maverick_400b": 1}
WHISPER_FRAMES, XLSTM_SEQ, ROUTER_SCALE = 1500, 1024, 20.0
#: xLSTM's float32 decode-vs-forward tolerance (DECODE_TOL for the rest):
#: its exponentially gated recurrences amplify float32 round-off along the
#: sequence, so the float32 forward and decode each sit some 1e-4 to 1e-3
#: of max |logit| from a forward of the same weights with float64
#: projections, which the phase also computes and holds both to.
XLSTM_DECODE_TOL = 5e-3
#: slice 11 (phase 23): the full-width train step's architecture, batch,
#: length, untimed and timed steps and peak learning rate (reached by a
#: linear warmup over the whole run: after a 2-step warmup, 1e-4 spikes
#: the full-width gnorm 20-fold, as Adam's first sign-like steps move every
#: weight of a random 28-layer model at once); the card-against-CPU
#: gradient tolerances, each leaf against its largest CPU entry: the
#: full-width float32 check (2 layers) and the SMOKE train steps, as phase
#: 22's card-against-CPU forward; TRAIN_GRAD_TOLS overrides the latter for
#: two architectures: jamba (a gradient leaf sums over tokens products
#: that partly cancel, through Mamba and MoE layers and the card's
#: atomics; 1.129e-4 on a norm scale's gradient, the same in two runs on
#: the card) and xLSTM (its gated recurrences amplify round-off through
#: depth: its CPU parity with the JAX package is held to 2e-3 for the
#: same reason); the resumed run's tolerance
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "llama3_2_3b", 2, 2048
TRAIN_WARM, TRAIN_STEPS, TRAIN_LR = 2, 8, 1e-4
FULL_GRAD_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-4
TRAIN_GRAD_TOLS = {"jamba_1_5_large_398b": 2.5e-4, "xlstm_1_3b": 2e-3}
RESUME_TOL = 1e-4
#: slice 12 (phase 24): the dry run's measured cells (one period each, at
#: one device's share of the single-pod mesh), the one that must be
#: recorded as not fitting the card, and the largest compute_fraction
#: allowed (its FLOPs are exact counts, so above 1 only by timing noise)
DRYRUN_MEASURED = (("llama3_2_3b", "train_4k"), ("llama3_2_3b", "prefill_32k"),
                   ("llama3_2_3b", "decode_32k"), ("grok_1_314b", "prefill_32k"),
                   ("xlstm_1_3b", "long_500k"),
                   ("jamba_1_5_large_398b", "train_4k"))
DRYRUN_NO_FIT = (("jamba_1_5_large_398b", "train_4k"),)
FRACTION_MAX = 1.05
#: the measured cells whose step runs once more under the profiler: the
#: train and prefill cells, furthest under the compute roofline
DRYRUN_PROFILED = (("llama3_2_3b", "train_4k"),
                   ("llama3_2_3b", "prefill_32k"),
                   ("grok_1_314b", "prefill_32k"))

#: slice 13 (phase 25): training on a mesh of MESH_WORLD ranks (one
#: process a rank; ``nccl`` with a card a rank where the machine has that
#: many cards, else ``gloo`` with the ranks sharing the card).  (a)
#: ``compressed_psum`` of MESH_PSUM_N float32 values a rank; (b) the SMOKE
#: configs MESH_RUNS (architecture, MoE capacity factor: 8 drops no
#: token, None is the config's own) in float32, MESH_STEPS steps on (2, 2) under each
#: layout against the one-device trainer on the card and on the CPU
#: (MESH_LOSS_TOL, the CPU tests' relative tolerance), resume and elastic
#: restore; (c) TRAIN_ARCH at its published widths cut to
#: MESH_FULL_PERIODS periods, bf16 with float32 AdamW, global batch
#: MESH_FULL_BATCH x MESH_FULL_SEQ on (2, 2) under ``tp``:
#: MESH_FULL_WARM untimed and MESH_FULL_TIMED timed steps, then a step
#: under the profiler, a save, MESH_FULL_NEXT more steps straight on and
#: the same steps resumed on (4, 1).  MESH_BF16_TOL bounds the distance
#: of those resumed bf16 losses from the straight ones (measured 1.0e-5),
#: and the same steps from fresh weights (the control: what a restore
#: that loaded nothing gives) must lie at least 10x further off.
#: The ranks take
#: the settings MESH_SETTINGS from this process (a CPU rehearsal lowers
#: them).
MESH_WORLD, MESH_PSUM_N = 4, 1 << 22
MESH_RUNS = (("qwen2_5_3b", 8.0), ("grok_1_314b", 8.0), ("grok_1_314b", None))
MESH_STEPS, MESH_LOSS_TOL = 4, 1e-5
MESH_FULL_PERIODS, MESH_FULL_BATCH, MESH_FULL_SEQ = 2, 4, 2048
MESH_FULL_WARM, MESH_FULL_TIMED, MESH_FULL_NEXT = 1, 3, 2
MESH_BF16_TOL = 1e-4
MESH_SETTINGS = ("DEVICE", "LM_WIDTHS", "MESH_PSUM_N", "MESH_STEPS",
                 "MESH_FULL_SEQ", "MESH_FULL_BATCH", "MESH_FULL_TIMED")


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def dropped(name: str) -> int:
    """Iterations ``run_chunk`` enqueued past the end of solver ``name``'s
    run and discarded since the counters were reset (at most one per
    ``run_chunk`` call): they launch their kernels like any other."""
    return execution.discarded_counts().get(name, 0)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64 (complex128 for complex
    operands)."""
    if got is None and want is None:
        return 0.0
    wide = (torch.complex128 if got.is_complex() or want.is_complex()
            else torch.float64)
    got, want = got.to(wide), want.to(wide)
    require(got.shape == want.shape,
            f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if want.numel() == 0:
        return 0.0
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return diff / scale if scale > 0 else diff


def time_ms(fn, warmup: int = 20, iters: int = 100) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def phase_environment() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}  torch.version.cuda {torch.version.cuda}"
          f"  device {torch.cuda.get_device_name(0)}"
          f"  capability {torch.cuda.get_device_capability(0)}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print("nvcc:", nvcc[-1] if nvcc else "?")
    return card


# ------------------------------------------------------------------ phase 2
#: B6's template instances in mangled names: (lanes per channel, states per
#: lane, whether it adds to y: the later state groups past 512 states)
SCAN_INSTANCE = r"mamba_scan_rowsILi(\d+)ELi(\d+)E(?:Lb([01])E)?"
#: B6's instances: (lanes, states a lane) of 1-4, 1-8, 1-16, 2-16, 4-16,
#: 8-16, 16-16 and 32-16, each storing y and adding to it
SCAN_INSTANCES = 16


def sass_hot_loop(lib: Path, pattern: str = SCAN_INSTANCE):
    """``hot_loops`` of the SASS of the library ``lib`` (``cuobjdump
    -sass``)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return hot_loops(out, pattern)


def hot_loops(sass: str, pattern: str = SCAN_INSTANCE):
    """For each function in the SASS listing ``sass`` whose mangled name
    matches ``pattern``: its innermost loop (a backward branch with no
    other inside it) with the most MUFU.EX2 instructions, as ``{"<l,n>":
    (instructions, MUFU.EX2, {opcode: count})}``.  One MUFU.EX2 is one
    state update, so instructions / MUFU.EX2 is what a state update
    costs."""
    loops = {}
    for chunk in sass.split("Function : ")[1:]:
        m = re.search(pattern, chunk.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t.strip()))
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                      chunk)]
        spans = []
        for a, t in ins:
            target = re.search(r"0x([0-9a-f]+)", t)
            if t.startswith("BRA") and target and int(target.group(1), 16) < a:
                spans.append((int(target.group(1), 16), a))
        best = (0, 0, {})
        for lo, hi in spans:
            if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi for o in spans):
                continue                              # not innermost
            ops = [t.split()[0] for a, t in ins if lo <= a <= hi]
            mufu = sum(op.startswith("MUFU.EX2") for op in ops)
            if mufu > best[1]:
                hist = {}
                for op in ops:
                    hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
                best = (len(ops), mufu, hist)
        loops["<" + ",".join(g for g in m.groups() if g) + ">"] = best
    return loops


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name in _build.sources():
        log = _build.build_log(name)
        require(log is not None, f"build: no compiler report for {name}")
        # one line per template instance: registers, shared memory, spills
        entry, spill = "?", ""
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                inst = re.search(r"(sellcs_spmv_fused|"
                                 r"tsmttsm_partial|tsmttsm_finish|"
                                 r"tsmttsm_dmma|herm_eig_wide|"
                                 r"tsmm_stream|tsmm_tiled|tsmm_dmma|"
                                 r"block_diag_rows|block_diag_stream|"
                                 r"block_diag_tiled|herm_eig_block|"
                                 r"axpby_dots_partial|"
                                 r"axpby_dots_finish|mamba_scan_rows)"
                                 r"(?:I(\w+?)E+v)?",
                                 m.group(1))
                entry = (m.group(1) if not inst else inst.group(1)
                         if inst.group(2) is None
                         else f"{inst.group(1)}<{inst.group(2)}>")
            elif "spill" in line:
                spill = line.strip()
                # B6, B2 (every instance, complex ones and the DMMA one
                # included), the block-Jacobi eigensolver, B3's wide
                # float64 instance and B4's wide float64 ones must not spill
                require(not entry.startswith(("mamba_scan_rows", "tsmttsm_",
                                              "herm_eig_wide", "tsmm_dmma",
                                              "block_diag_stream<dd",
                                              "block_diag_tiled<dd"))
                        or ("0 bytes spill stores" in spill
                            and "0 bytes spill loads" in spill),
                        f"build: {entry} spills: {spill}")
            elif "registers" in line:
                regs = re.search(r"Used \d+ registers", line)
                smem = re.search(r"\d+ bytes smem", line)
                print(f"[ptxas] {name}{entry}: "
                      f"{regs.group(0) if regs else '?'}, "
                      f"{smem.group(0) if smem else 'no smem'}; {spill}")
    loops = sass_hot_loop(_build._library_path("mamba_scan"))
    require(len(loops) == SCAN_INSTANCES,
            f"build: mamba_scan_rows instances {list(loops)}")
    for inst, (n, mufu, hist) in loops.items():
        require(mufu > 0, f"build: no MUFU.EX2 loop in mamba_scan_rows{inst}")
        npl = int(inst.strip("<>").split(",")[1])
        mix = ", ".join(f"{op} {k}" for op, k in
                        sorted(hist.items(), key=lambda kv: -kv[1]))
        print(f"[sass] mamba_scan_rows{inst} hot loop: {n} instructions for "
              f"{mufu} MUFU.EX2 = {n / mufu:.2f} per state update, "
              f"{n * npl / mufu:.1f} per timestep of a thread ({mix})")


# ------------------------------------------------------------------ phase 3
def _grid_coo(n: int, ncols: int, rng, empty_every: int = 0):
    """Random COO with ragged rows (0..23 entries, a few of 60)."""
    rowlen = rng.integers(0, 24, n)
    rowlen[rng.random(n) < 0.02] = 60
    if empty_every:
        rowlen[::empty_every] = 0
        rowlen[: min(n, 70)] = 0                      # whole empty chunks
    rows = np.repeat(np.arange(n), rowlen)
    cols = rng.integers(0, ncols, rows.size)
    vals = rng.standard_normal(rows.size)
    return rows, cols, vals


def _flag_cases(b: int, rng, np_ct):
    gam = rng.standard_normal(b).astype(np_ct)
    return [
        ("plain", SpmvOpts(), False, False),
        ("alpha_beta", SpmvOpts(alpha=0.7, beta=-1.3), True, False),
        ("gamma_scalar", SpmvOpts(alpha=1.2, gamma=0.25), False, False),
        ("gamma_column", SpmvOpts(gamma=gam), True, False),
        ("chain", SpmvOpts(alpha=1.1, beta=0.5, delta=0.3, eta=-0.8),
         True, True),
        ("dots", SpmvOpts(alpha=0.9, beta=0.4, dot_yy=True, dot_xy=True,
                          dot_xx=True), True, False),
    ]


def _compare(A, x, y, z, opts, tol, tag, worst):
    yk, zk, dk = sellcs_spmv(A, x, y, z, opts)
    yr, zr, dr = sellcs_spmv_ref(A, x, y, z, opts)
    sync()
    require(yk.dtype == yr.dtype and (dk is None or dk.dtype == dr.dtype),
            f"kernel vs plain {tag}: dtypes {yk.dtype} / {yr.dtype}")
    errs = {"y": rel_err(yk, yr), "z": rel_err(zk, zr),
            "dots": rel_err(dk, dr)}
    for key, lim in (("y", tol["vec"]), ("z", tol["vec"]),
                     ("dots", tol["dots"])):
        require(errs[key] <= lim,
                f"kernel vs plain {tag}: {key} rel err {errs[key]:.3e} > {lim}")
    e = max(errs.values())
    if e >= worst[0]:
        worst[:] = [e, tag]
    return e


def phase_grid() -> None:
    rng = np.random.default_rng(0)
    dev = DEVICE
    n_cases = 0
    t0 = time.perf_counter()
    for sd, np_ct in GRID_PAIRS:
        ct = torch.float64 if np_ct is np.float64 else torch.float32
        tol = TOL[ct]
        per_flag = {}
        for C in (8, 32, 128):
            n = 16 * C + 5                        # ragged last chunk
            rows, cols, vals = _grid_coo(n, n, rng)
            for sigma in (1, C, 4 * C):
                A = from_coo(rows, cols, vals, (n, n), C=C, sigma=sigma,
                             dtype=np_ct, store_dtype=sd, device=dev)
                for b in (1, 3, 8, 16):
                    x = torch.randn(A.nrows_pad, b, dtype=ct, device=dev)
                    y = torch.randn_like(x)
                    z = torch.randn_like(x)
                    for name, opts, with_y, with_z in _flag_cases(b, rng, np_ct):
                        worst = per_flag.setdefault(name, [0.0, ""])
                        _compare(A, x, y if with_y else None,
                                 z if with_z else None, opts, tol,
                                 f"{sd}/{ct} C={C} sigma={sigma} b={b} {name}",
                                 worst)
                        n_cases += 1
            # a rectangular part: x has ncols rows; no shift, no x-dots
            m = 11 * C + 3
            rr, rc, rv = _grid_coo(n, m, rng)
            R = from_coo(rr, rc, rv, (n, m), C=C, sigma=4 * C, dtype=np_ct,
                         store_dtype=sd, device=dev)
            for b in (1, 3, 8, 16):
                x = torch.randn(m, b, dtype=ct, device=dev)
                y = torch.randn(R.nrows_pad, b, dtype=ct, device=dev)
                z = torch.randn_like(y)
                opts = SpmvOpts(alpha=0.6, beta=1.5, delta=2.0, eta=0.5,
                                dot_yy=True)
                _compare(R, x, y, z, opts, tol,
                         f"{sd}/{ct} C={C} b={b} rectangular",
                         per_flag.setdefault("rectangular", [0.0, ""]))
                n_cases += 1
        # empty rows (and whole empty chunks), and empty matrices
        n = 999
        rows, cols, vals = _grid_coo(n, n, rng, empty_every=3)
        extra = [("empty_rows", rows, cols, vals, n),
                 ("empty_matrix", [], [], [], 100),
                 ("zero_rows", [], [], [], 0)]
        for name, r_, c_, v_, nn in extra:
            A = from_coo(r_, c_, v_, (nn, nn), C=32, sigma=128, dtype=np_ct,
                         store_dtype=sd, device=dev)
            for b in (1, 3, 16):
                x = torch.randn(A.nrows_pad, b, dtype=ct, device=dev)
                y = torch.randn_like(x)
                opts = SpmvOpts(alpha=1.0, beta=-1.0, gamma=0.5, dot_yy=True,
                                dot_xy=True, dot_xx=True)
                _compare(A, x, y, None, opts, tol, f"{sd}/{ct} {name} b={b}",
                         per_flag.setdefault(name, [0.0, ""]))
                n_cases += 1
        for name, (err, tag) in per_flag.items():
            print(f"[grid] store={str(sd)[6:]} compute={str(ct)[6:]} "
                  f"{name:13s} max rel err {err:.3e}  (worst: {tag})")
    print(f"[grid] {n_cases} cases within tolerance "
          f"(f64 1e-12; f32 vectors 1e-5, dots 1e-6) in "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phase 4
def phase_case_study() -> None:
    r, c, v, n = matpde(16, beta_c=0.0)
    A = from_coo(r, c, v, (n, n), C=16, sigma=32, w_align=4, dtype=np.float32,
                 device=DEVICE)
    require(A.beta > 0.5, f"beta {A.beta}")
    op = make_operator(A)
    b = np.random.default_rng(0).standard_normal((n, 2)).astype(np.float32)
    execution.reset_launch_counts()
    res = cg(op, A.permute(b), tol=1e-6, maxiter=600)
    sync()
    launches = execution.launch_counts().get(KERNEL, 0)
    conv = bool(res.converged.all())
    d = dropped("cg")
    print(f"[case study] matpde(16) f32 b=2: {res.iters} iterations, "
          f"converged={conv}, kernel launches {launches} ({d} discarded "
          f"iteration)")
    require(conv, "case study did not converge")
    require(d <= 1, f"case study: {d} discarded iterations in one chunk")
    require(launches == res.iters + d + 1,
            f"case study: {launches} launches != iters + discarded + 1 = "
            f"{res.iters + d + 1}")


# ------------------------------------------------------------------ phase 5
def _true_relres(A, b, x) -> float:
    Ax, _, _ = sellcs_spmv_ref(A, x)
    return ((b - Ax).norm(dim=0) / b.norm(dim=0)).max().item()


def _solve(A, b, tol, label, card):
    op = make_operator(A)
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=tol, maxiter=3000)
    sync()
    secs = time.perf_counter() - t0
    launches = execution.launch_counts().get(KERNEL, 0)
    d = dropped("cg")
    relres = _true_relres(A, b, res.x)
    conv = bool(res.converged.all())
    print(f"[full width] {label}: {res.iters} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(res.iters, 1):.3f} ms/iter), converged={conv}, "
          f"true rel residual {relres:.3e} (tol {tol}), kernel launches "
          f"{launches} ({d} discarded iteration)  [{card}]")
    require(conv, f"{label}: not converged")
    require(relres <= 10 * tol, f"{label}: true residual {relres} > {10 * tol}")
    require(d <= 1, f"{label}: {d} discarded iterations in one chunk")
    require(launches == res.iters + d + 1,
            f"{label}: {launches} launches != iters + discarded + 1 = "
            f"{res.iters + d + 1}")
    return res, launches, secs


def phase_full_width(card):
    r, c, v, n = laplace3d(NX)
    rng = np.random.default_rng(0)
    b_host = rng.standard_normal((n, 4))
    out = {}

    t0 = time.perf_counter()
    A64 = from_coo(r, c, v, (n, n), C=32, sigma=1024, dtype=np.float64,
                   device=DEVICE)
    sync()
    print(f"[full width] laplace3d({NX}) n={n} nnz={A64.nnz} cap={A64.cap} "
          f"beta={A64.beta:.4f}: f64 build {time.perf_counter() - t0:.1f} s")
    b64 = A64.permute(torch.from_numpy(b_host))
    res64, launches, secs = _solve(A64, b64, 1e-8, "(a) column CG f64 b=4", card)
    out["launches"], out["solve_s"] = launches, {"f64": secs}
    out["iters64"], out["b_host"] = int(res64.iters), b_host

    # the same solve in cg_step chunks of 64 must equal it bit for bit
    op = make_operator(A64)
    st = cg_init(op, b64, tol=1e-8, maxiter=3000)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 64)
    ch = cg_finalize(st)
    same = (ch.iters == res64.iters and torch.equal(ch.x, res64.x)
            and torch.equal(ch.resnorm, res64.resnorm))
    print(f"[full width] (a) as cg_step chunks of 64: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked f64 solve differs from the monolithic one")

    t0 = time.perf_counter()
    A16 = from_coo(r, c, v, (n, n), C=32, sigma=1024, dtype=np.float32,
                   store_dtype=torch.bfloat16, device=DEVICE)
    sync()
    print(f"[full width] bf16-store/f32 build {time.perf_counter() - t0:.1f} s")
    b32 = A16.permute(torch.from_numpy(b_host.astype(np.float32)))
    _, launches16, secs = _solve(A16, b32, 1e-5,
                                 "(b) column CG bf16 store, f32 compute, b=4", card)
    out["solve_s"]["bf16-store/f32"] = secs
    out["launches16"] = launches16
    out["A64"], out["A16"] = A64, A16
    out["coo"] = (r, c, v, n)
    return out


# ------------------------------------------------------------------ phase 6
def phase_quickstart(A) -> None:
    g = torch.Generator(device=DEVICE).manual_seed(1)
    x = torch.randn(A.nrows_pad, 4, dtype=A.dtype, device=DEVICE, generator=g)
    y = torch.randn(A.nrows_pad, 4, dtype=A.dtype, device=DEVICE, generator=g)
    opts = SpmvOpts(alpha=1.0, beta=-1.0, gamma=np.array([0.5, -0.25, 1.0, 2.0]),
                    dot_yy=True, dot_xy=True, dot_xx=True)
    worst = [0.0, ""]
    e = _compare(A, x, y, None, opts, TOL[torch.float64], "quickstart", worst)
    print(f"[quickstart] laplace3d({NX}) f64 b=4, alpha=1 beta=-1 per-column "
          f"gamma, all dots: kernel vs plain max rel err {e:.3e}")


# ------------------------------------------------------------------ phase 7
def _library_csr(A, coo):
    """The same matrix, permuted, as a torch CSR tensor (yardstick only)."""
    r, c, v, n = coo
    ip = A.iperm.cpu().numpy().astype(np.int64)
    idx = torch.from_numpy(np.stack([ip[r], ip[c]])).to(DEVICE)
    val = torch.from_numpy(np.asarray(v)).to(DEVICE)
    with warnings.catch_warnings():        # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, val, (A.nrows_pad, A.nrows_pad)
                                       ).coalesce().to_sparse_csr()


def phase_timing(fw, card):
    A64, A16 = fw["A64"], fw["A16"]
    csr = _library_csr(A64, fw["coo"])
    rows = []
    for label, A in (("f64", A64), ("bf16-store/f32", A16)):
        for b, dot in SPMV_TIMED:
            g = torch.Generator(device="cuda").manual_seed(2)
            x = torch.randn(A.nrows_pad, b, dtype=A.dtype, device="cuda",
                            generator=g)
            opts = SpmvOpts(dot_xy=dot)    # what CG / block CG ask of it
            yk, _, dk = sellcs_spmv(A, x, opts=opts)
            yr, _, dr = sellcs_spmv_ref(A, x, opts=opts)
            err = (yk.double() - yr.double()).abs().max().item()
            dots_err = rel_err(dk, dr)
            require(dots_err <= TOL[A.dtype]["dots"],
                    f"timing inputs: dots rel err {dots_err}")
            ms = time_ms(lambda: sellcs_spmv(A, x, opts=opts))
            plain_ms = time_ms(lambda: sellcs_spmv_ref(A, x, opts=opts),
                               warmup=3, iters=20)
            lib_ms = None
            if A.dtype == torch.float64:
                lib_err = rel_err(csr @ x, yk)
                require(lib_err <= 1e-12, f"library product disagrees {lib_err}")
                lib_ms = time_ms(lambda: csr @ x)
                if lib_ms < ms:
                    print(f"[timing] f64 b={b}: the library's csr @ x "
                          f"({lib_ms:.4f} ms) is faster than the kernel "
                          f"({ms:.4f} ms)")
            nbytes = _spmv_bytes(A, x, yk, dk)
            bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            gbs = nbytes / (ms * 1e-3) / 1e9
            print(f"[timing] {label} b={b} {'<p, Ap>' if dot else 'no dots'}"
                  f": kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library(csr@x) "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB needed; the "
                  f"matrix stores {_stored_bytes(A) / 1e6:.1f} MB), "
                  f"{gbs:.1f} GB/s = {100 * bound_ms / ms:.1f}% of bound, "
                  f"y max abs err {err:.3e}, dots rel err {dots_err:.3e}  "
                  f"[{card}]")
            rows.append(dict(label=label, b=b, dot=dot, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, err=err))
    return rows




# ------------------------------------------------------------------ phase 4
#: unit roundoff of the accumulation dtype (float32 for the half types)
#: and of the output dtype (the result rounds once more)
_ACC_UNIT = {torch.float64: 2.0 ** -53, torch.float32: 2.0 ** -24,
             torch.bfloat16: 2.0 ** -24, torch.float16: 2.0 ** -24}
_OUT_UNIT = {torch.float64: 0.0, torch.float32: 0.0,
             torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
#: (alpha, beta, with the output operand)
TSM_COEFS = ((1.0, 0.0, False), (0.5, -2.0, True), (-1.0, 1.0, True))
#: float32 inputs over many rows: the root-mean-square error of the Kahan
#: sum must be at most this share of the plain sum's on the same inputs
#: (a float32 emulation of the kernel's order gives about 1/4 at 2^20 and
#: at 4,096,000 rows; a kernel that ignored ``kahan`` would give 1).  The
#: float64 DMMA instance is held to the same share against exact sums
#: (:func:`_require_exact_kahan`; an emulation of its order gives 0.17 off
#: the diagonal and 0.30 on a self-Gram's at 2^18 rows, 0.04 and 0.31 at
#: 4,096,000; without folds, or with the compensation's sign flipped, 1 or
#: more)
KAHAN_GAIN = 0.5
#: result entries of a float64 B2 call summed exactly
EXACT_ENTRIES = 32


def kahan_depth(n: int, m: int, k: int, dt, values=None) -> float:
    """The depth of the compensated bound of the Kahan kernel: a lane's
    8-row group summed plainly (with the products' rounding; on the FP64
    tensor cores, float64 past 4096 entries, two mma k-steps of four rows
    from zero, at most eight additions in the tensor core's order), then
    three compensated levels at ``2u + O(N u^2)`` each, with ``N`` at most
    the plain depth.  Since the finishing kernel sums the blocks in runs,
    the 4 x 4 tiles' kernel has four such levels (the lane's groups, the
    lanes, a run of blocks, the runs) and the DMMA one three (no lanes);
    the check keeps the three levels' bound, the tighter one.  ``dt`` is
    the accumulation dtype, ``values`` the operands' where they differ
    from it (complex values, whose tile sets the partition)."""
    d = summation_depth(n, m, k, dt if values is None else values)
    return 8 + 3 * (2 + 2 * d * d * _ACC_UNIT[dt])


def _tsm_check(got, want, scale, dt, depth, n_plain, tag, worst=None):
    """``got`` against the float64 plain ``want``.  A sum of depth ``d`` in
    unit roundoff ``u`` errs by at most ``d * u * sum |terms|`` in any
    order (``scale`` = sum |terms|): the kernel's depth in its
    accumulation dtype (or the compensated depth of :func:`kahan_depth`),
    plus the float64 plain version's (at most its length), plus
    alpha/beta and the output's own rounding (relative, or one subnormal
    spacing near zero).  Returns ``|got - want|``."""
    require(got.shape == want.shape and got.dtype == dt,
            f"{tag}: got {tuple(got.shape)} {got.dtype}")
    fi = torch.finfo(dt)          # the output's subnormal spacing: tiny * eps
    lim = (((depth + 3) * _ACC_UNIT[dt] + (n_plain + 3) * 2.0 ** -53) * scale
           + _OUT_UNIT[dt] * want.abs() + fi.tiny * fi.eps)
    err = (got.double() - want).abs()
    if err.numel() == 0:
        return err
    ratio, emax = float((err / (lim + 1e-300)).max()), float(err.max())
    require(ratio <= 1.0, f"tsm {tag}: error {emax:.3e} above its "
                          f"bound ({ratio:.2f}x)")
    if worst is not None and ratio >= worst[0]:
        worst[:] = [ratio, tag, emax]
    return err


def _rms(errs) -> float:
    return float(torch.cat([e.flatten() for e in errs]).square().mean().sqrt())


def _require_kahan_gain(errs, tag) -> str:
    """The Kahan sum's error at most :data:`KAHAN_GAIN` of the plain sum's
    (root-mean-square, over ``errs[True]`` and ``errs[False]``)."""
    kahan, plain = _rms(errs[True]), _rms(errs[False])
    require(kahan <= KAHAN_GAIN * plain or DEVICE == "cpu",
            f"{tag}: Kahan rms error {kahan:.3e} not below {KAHAN_GAIN} x "
            f"the plain sum's {plain:.3e}")
    return (f"rms error Kahan {kahan:.3e}, plain {plain:.3e} "
            f"({kahan / max(plain, 1e-300):.3f}, at most {KAHAN_GAIN})")


def _exact_sample(m, k, g):
    """``(rows, cols)`` of :data:`EXACT_ENTRIES` entries of an (m, k)
    result: the four corners, the diagonal's ends and middle, the rest at
    random (from ``g``)."""
    d = min(m, k) - 1
    rows = [0, 0, m - 1, m - 1, d, d // 2]
    cols = [0, k - 1, 0, k - 1, d, d // 2]
    more = EXACT_ENTRIES - len(rows)
    rows += torch.randint(m, (more,), generator=g, device=g.device).tolist()
    cols += torch.randint(k, (more,), generator=g, device=g.device).tolist()
    return rows, cols


def _require_exact_kahan(V, W, kahan, plain, g, tag) -> str:
    """B2's float64 Kahan sum ``kahan`` and plain sum ``plain`` of V^T W
    held against exact sums of sampled entries
    (``tsmttsm_exact_entries``): the Kahan sum within its compensated
    bound (``kahan_depth`` units of 2^-53 of sum |terms|, with no term for
    a reference's own rounding), and its root-mean-square error at most
    :data:`KAHAN_GAIN` of the plain sum's, each entry's error in units of
    the least it could be: the exact sum's ulp plus 2^-53 sqrt(sum
    terms^2) (one rounding a term, at random).  The float64 plain version
    errs by up to n units and would hide a kernel that does not
    compensate; so scaled, neither the large sums of a self-Gram's
    diagonal (well conditioned: both sums within about an ulp) nor sums
    that cancel to near zero drown the entries where compensation
    tells."""
    n, m = V.shape
    k = W.shape[1]
    rows, cols = _exact_sample(m, k, g)
    hi, lo = tsmttsm_exact_entries(V, W, rows, cols)
    ri = torch.as_tensor(rows, device=V.device)
    ci = torch.as_tensor(cols, device=V.device)
    scale = (V[:, ri].abs() * W[:, ci].abs()).sum(0)
    errs = {flag: ((got[ri, ci] - hi) - lo).abs()
            for flag, got in ((True, kahan), (False, plain))}
    depth = kahan_depth(n, m, k, torch.float64)
    fi = torch.finfo(torch.float64)
    lim = (depth + 3) * 2.0 ** -53 * scale + fi.tiny * fi.eps
    ratio = float((errs[True] / lim).max())
    unit = (torch.ldexp(torch.ones_like(hi), torch.frexp(hi)[1] - 53)
            + 2.0 ** -53 * (V[:, ri] * W[:, ci]).square().sum(0).sqrt())
    k_rms, p_rms = (float((errs[f] / unit).square().mean().sqrt())
                    for f in (True, False))
    require(ratio <= 1.0 or DEVICE == "cpu",
            f"{tag}: Kahan error {float(errs[True].max()):.3e} against exact "
            f"sums above its bound ({ratio:.2f}x)")
    require(k_rms <= KAHAN_GAIN * p_rms or DEVICE == "cpu",
            f"{tag}: Kahan rms error {k_rms:.3f} units against exact sums "
            f"not below {KAHAN_GAIN} x the plain sum's {p_rms:.3f}")
    return (f"{len(rows)} entries summed exactly: Kahan max abs error "
            f"{float(errs[True].max()):.3e} ({ratio:.4f} of its bound), rms "
            f"{k_rms:.3f} units, plain {p_rms:.3f} units "
            f"({k_rms / max(p_rms, 1e-300):.3f}, at most {KAHAN_GAIN})")


def phase_tsm_grid() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(3)
    worst = {}
    n_cases = 0
    gain = {False: [], True: []}      # float32 at the most rows
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        for n in TSM_NS:
            for m in TSM_DIMS:
                for k in TSM_DIMS:
                    V, W, X, Xs = (torch.randn(*shape, generator=g,
                                               dtype=torch.float64,
                                               device=DEVICE).to(dt)
                                   for shape in ((n, m), (n, k), (m, k),
                                                 (m, k)))
                    Vd, Wd, Xd, Xsd = (t.double() for t in (V, W, X, Xs))
                    vw = Vd.abs().T @ Wd.abs()
                    vx = Vd.abs() @ Xsd.abs()
                    d2 = summation_depth(n, m, k)
                    for alpha, beta, out in TSM_COEFS:
                        tag = (f"{str(dt)[6:]} n={n} m={m} k={k} "
                               f"alpha={alpha} beta={beta}")
                        want = tsmttsm_ref(Vd, Wd, Xd if out else None,
                                           alpha, beta)
                        scale = abs(alpha) * vw + abs(beta) * Xd.abs()
                        for kahan in (False, True):
                            got = tsmttsm(V, W, X if out else None, alpha,
                                          beta, kahan=kahan)
                            key = ("tsmttsm" + (" kahan" if kahan else ""),
                                   str(dt)[6:])
                            depth = (kahan_depth(n, m, k, dt) if kahan
                                     else d2)
                            err = _tsm_check(
                                got, want, scale, dt, depth, n,
                                tag + f" kahan={kahan}",
                                worst.setdefault(key, [0.0, "", 0.0]))
                            if dt == torch.float32 and n == max(TSM_NS):
                                gain[kahan].append(err)
                        want = tsmm_ref(Vd, Xsd, Wd if out else None, alpha,
                                        beta)
                        scale = abs(alpha) * vx + abs(beta) * Wd.abs()
                        got = tsmm(V, Xs, W if out else None, alpha, beta)
                        key = ("tsmm" + (" W" if out else ""), str(dt)[6:])
                        _tsm_check(got, want, scale, dt, m, m, tag,
                                   worst.setdefault(key, [0.0, "", 0.0]))
                        n_cases += 3
        # V and W one value into their buffers: B2's stages fill by plain
        # loads where a bulk copy cannot take them
        for n in TSM_NS[1:]:
            for m, k in TSM_ODD:
                V, W = (torch.randn(n * w + 1, generator=g,
                                    dtype=torch.float64,
                                    device=DEVICE).to(dt)[1:].view(n, w)
                        for w in (m, k))
                Vd, Wd = V.double(), W.double()
                want = tsmttsm_ref(Vd, Wd)
                for kahan in (False, True):
                    got = tsmttsm(V, W, kahan=kahan)
                    key = ("tsmttsm view" + (" kahan" if kahan else ""),
                           str(dt)[6:])
                    depth = (kahan_depth(n, m, k, dt) if kahan
                             else summation_depth(n, m, k))
                    _tsm_check(got, want, Vd.abs().T @ Wd.abs(), dt, depth,
                               n, f"{str(dt)[6:]} n={n} m={m} k={k} view "
                               f"kahan={kahan}",
                               worst.setdefault(key, [0.0, "", 0.0]))
                    n_cases += 1
        # B3's other template widths, and B3 on views off a 16-byte
        # boundary (the same bits as on aligned copies)
        for n in TSM_NS:
            for w in TSMM_SQUARES:
                V, W, X = (torch.randn(*shape, generator=g,
                                       dtype=torch.float64,
                                       device=DEVICE).to(dt)
                           for shape in ((n, w), (n, w), (w, w)))
                Vd, Wd, Xd = (t.double() for t in (V, W, X))
                for alpha, beta, out in TSM_COEFS:
                    got = tsmm(V, X, W if out else None, alpha, beta)
                    _tsm_check(got, tsmm_ref(Vd, Xd, Wd if out else None,
                                             alpha, beta),
                               abs(alpha) * (Vd.abs() @ Xd.abs())
                               + abs(beta) * Wd.abs(), dt, w, w,
                               f"{str(dt)[6:]} n={n} m=k={w} alpha={alpha}",
                               worst.setdefault(("tsmm" + (" W" if out
                                                           else ""),
                                                 str(dt)[6:]),
                                                [0.0, "", 0.0]))
                    n_cases += 1
            for m, k in TSMM_ODD:
                V, W = (torch.randn(n * w + 1, generator=g,
                                    dtype=torch.float64,
                                    device=DEVICE).to(dt)[1:].view(n, w)
                        for w in (m, k))
                X = torch.randn(m, k, generator=g, dtype=torch.float64,
                                device=DEVICE).to(dt)
                got = tsmm(V, X, W, 0.5, -2.0)
                require(torch.equal(got, tsmm(V.clone(), X, W.clone(), 0.5,
                                              -2.0)),
                        f"tsmm {dt} n={n} m={m} k={k}: a view off a 16-byte "
                        f"boundary gives other bits than its aligned copy")
                Vd, Wd, Xd = V.double(), W.double(), X.double()
                _tsm_check(got, tsmm_ref(Vd, Xd, Wd, 0.5, -2.0),
                           0.5 * (Vd.abs() @ Xd.abs()) + 2.0 * Wd.abs(), dt,
                           m, m, f"{str(dt)[6:]} n={n} m={m} k={k} view",
                           worst.setdefault(("tsmm view", str(dt)[6:]),
                                            [0.0, "", 0.0]))
                n_cases += 1
    for (kern, dt), (ratio, tag, err) in sorted(worst.items()):
        print(f"[tsm grid] {kern:13s} {dt:9s} worst error {err:.3e} = "
              f"{ratio:.3f} of its bound  (at {tag})")
    print(f"[tsm grid] {n_cases} cases within their bounds: n in {TSM_NS}, "
          f"m, k in {TSM_DIMS}, alpha/beta {TSM_COEFS}; tsmttsm on views "
          f"off a 16-byte boundary at (m, k) in {TSM_ODD}; tsmm also at "
          f"m = k in {TSMM_SQUARES} (its other template widths) and on "
          f"views off a 16-byte boundary at (m, k) in {TSMM_ODD}, equal "
          f"to their aligned copies bit for bit")
    print(f"[tsm grid] tsmttsm float32 n={max(TSM_NS)}, all m, k, alpha/beta: "
          + _require_kahan_gain(gain, "tsm grid float32"))



# ------------------------------------------------------------------ phase 8
BLOCK_KERNELS = ("sellcs_spmv", "tsmttsm", "tsmm", "herm_eig")
PRECOND_KERNELS = ("sellcs_spmv", "block_diag_matmul")


def _counts(names=BLOCK_KERNELS):
    got = execution.launch_counts()
    return {k: got.get(k, 0) for k in names}


def _colwise_relres(A, b, x) -> torch.Tensor:
    """True relative residual per column, through the plain SpMV."""
    Ax, _, _ = sellcs_spmv_ref(A, x)
    return (b - Ax).norm(dim=0) / b.norm(dim=0)


def phase_block_cg(fw, card):
    """Slice 2's main path: cg(block=True) at full width."""
    A = fw["A64"]
    op = make_operator(A)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    b = A.permute(torch.randn(A.nrows, WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    tol = 1e-8
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=tol, maxiter=3000, block=True)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts()
    it = res.iters
    relres = _colwise_relres(A, b, res.x)
    ms_iter = 1e3 * secs / max(it, 1)
    print(f"[block cg] laplace3d({NX}) f64 width {WIDTH} tol {tol}: {it} "
          f"iterations in {secs:.3f} s ({ms_iter:.3f} ms/iter), converged="
          f"{bool(res.converged.all())}  [{card}]")
    print(f"[block cg] true relative residual per column: "
          f"{' '.join(f'{r:.2e}' for r in relres.tolist())}")
    d = dropped("block_cg")
    print(f"[block cg] launches {launches} (per iteration: 1 sellcs_spmv, "
          f"2 tsmttsm, 4 tsmm, 2 herm_eig; init: 1 each; {d} discarded "
          f"iteration)")
    require(bool(res.converged.all()), "block CG: not converged")
    require(float(relres.max()) <= 10 * tol,
            f"block CG: true residual {float(relres.max())} > {10 * tol}")
    require(d <= 1, f"block CG: {d} discarded iterations in one chunk")
    n_it = it + d
    want = {"sellcs_spmv": n_it + 1, "tsmttsm": 2 * n_it + 1,
            "tsmm": 4 * n_it + 1, "herm_eig": 2 * n_it + 1}
    require(launches == want or DEVICE == "cpu",
            f"block CG launches {launches} != {want}")

    # the same right-hand side through column CG: block sweeps <= column
    sync()
    t0 = time.perf_counter()
    col = cg(op, b, tol=tol, maxiter=3000)
    sync()
    col_secs = time.perf_counter() - t0
    print(f"[block cg] sweeps: block {it}, column CG on the same rhs "
          f"{col.iters} ({col.iters / max(it, 1):.2f}x); time to solution: "
          f"block {secs:.3f} s, column {col_secs:.3f} s "
          f"({1e3 * col_secs / max(col.iters, 1):.3f} ms/iter)  [{card}]")
    require(bool(col.converged.all()), "column CG: not converged")
    require(it <= col.iters, f"block CG took {it} > column {col.iters}")

    # cg_step chunks of 64 must equal the monolithic solve bit for bit
    st = cg_init(op, b, tol=tol, maxiter=3000, block=True)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 64)
    ch = cg_finalize(st)
    same = (ch.iters == it and torch.equal(ch.x, res.x)
            and torch.equal(ch.resnorm, res.resnorm))
    print(f"[block cg] as cg_step chunks of 64: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked block CG differs from the monolithic one")
    return dict(iters=it, secs=secs, ms_iter=ms_iter, launches=launches,
                op=op, b=b, state=st)


# ------------------------------------------------------------------ phase 9
def phase_block_minres(fw, card) -> int:
    A = fw["A64"]
    op = make_operator(A)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    b = A.permute(torch.randn(A.nrows, WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    tol = 1e-6
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = minres(op, b, tol=tol, maxiter=3000, block=True)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts()
    d = dropped("block_minres")
    relres = _colwise_relres(A, b, res.x)
    print(f"[block minres] laplace3d({NX}) f64 width {WIDTH} tol {tol}: "
          f"{res.iters} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(res.iters, 1):.3f} ms/iter), converged="
          f"{bool(res.converged.all())}, max true relative residual "
          f"{float(relres.max()):.3e}, launches {launches} (per iteration: 1 "
          f"sellcs_spmv, 4 tsmttsm, 9 tsmm, 1 herm_eig; init: 1 each; {d} "
          f"discarded iteration)  [{card}]")
    require(bool(res.converged.all()), "block MINRES: not converged")
    require(float(relres.max()) <= 10 * tol,
            f"block MINRES: true residual {float(relres.max())} > {10 * tol}")
    require(d <= 1, f"block MINRES: {d} discarded iterations in one chunk")
    it = res.iters + d
    want = {"sellcs_spmv": it + 1, "tsmttsm": 4 * it + 1, "tsmm": 9 * it + 1,
            "herm_eig": it + 1}
    require(launches == want or DEVICE == "cpu",
            f"block MINRES launches {launches} != {want}")
    return int(res.iters)


# ----------------------------------------------------------------- phase 10
def _laplace3d_eigs(nx: int) -> np.ndarray:
    """All eigenvalues of laplace3d(nx): sum over d of 2 - 2 cos(k_d pi / (nx+1))."""
    h = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    return np.sort((h[:, None, None] + h[None, :, None]
                    + h[None, None, :]).ravel())


def phase_eigen(fw, card) -> None:
    # Lanczos extrema of laplace3d(NX) must bracket the analytic extremes
    execution.reset_launch_counts()
    lo, hi = lanczos_extrema(make_operator(fw["A64"]))
    emin = 6.0 - 6.0 * np.cos(np.pi / (NX + 1))
    emax = 6.0 + 6.0 * np.cos(np.pi / (NX + 1))
    print(f"[eigen] lanczos_extrema laplace3d({NX}) f64: [{lo:.6f}, "
          f"{hi:.6f}] around the analytic [{emin:.6f}, {emax:.6f}], "
          f"launches {_counts()}")
    require(lo <= emin and hi >= emax, "Lanczos extrema do not bracket")

    # ChebFD on a laplace3d window with closed-form eigenvalues
    r, c, v, n = laplace3d(CHEB_NX)
    A = from_coo(r, c, v, (n, n), C=32, sigma=1, dtype=np.float64,
                 device=DEVICE)
    op = make_operator(A)
    ev = _laplace3d_eigs(CHEB_NX)
    t_lo, t_hi = CHEB_TARGET
    inside = ev[(ev >= t_lo) & (ev <= t_hi)]
    execution.reset_launch_counts()
    res = chebfd(op, CHEB_TARGET, block_size=8, degree=CHEB_DEGREE,
                 sweeps=CHEB_SWEEPS)
    sync()
    conv = (res.eigenvalues >= t_lo) & (res.eigenvalues <= t_hi)
    got, resid = res.eigenvalues[conv], res.residuals[conv]
    print(f"[eigen] chebfd laplace3d({CHEB_NX}) window {CHEB_TARGET}, "
          f"degree {CHEB_DEGREE}, {CHEB_SWEEPS} sweeps: Ritz values "
          f"{np.array2string(got, precision=10)} residuals "
          f"{np.array2string(resid, precision=2)}; analytic "
          f"{np.array2string(inside, precision=10)}; launches {_counts()}")
    require(got.size == inside.size,
            f"chebfd: {got.size} Ritz values in the window, "
            f"{inside.size} eigenvalues")
    require(bool(np.all(np.abs(got - inside) <= resid + 1e-12)),
            "chebfd: a Ritz value lies farther from its eigenvalue than its "
            "residual")

    # KPM moments at full width (float32 probes, bf16-store/f32 operator)
    op16 = make_operator(fw["A16"])
    execution.reset_launch_counts()
    mus = kpm_dos_moments(op16, 64, n_probes=4).double().cpu().numpy()
    print(f"[eigen] kpm_dos_moments laplace3d({NX}) bf16-store/f32, 4 "
          f"probes, 64 moments: mu_0 = {mus[0]:.7f}, max |mu_m| "
          f"(m >= 1) = {np.abs(mus[1:]).max():.5f}, launches {_counts()}")
    # mu_m = <v, T_m(A_s) v> with ||v|| = 1 and ||T_m(A_s)|| <= 1; the
    # float32 recurrence of 64 steps rounds by far less than 1e-3
    require(abs(mus[0] - 1.0) <= 1e-5, f"kpm: mu_0 = {mus[0]}")
    require(bool(np.all(np.abs(mus) <= 1.0 + 1e-3)), "kpm: |mu_m| > 1")


# ----------------------------------------------------------------- phase 11
#: H100 SXM peak rates outside the tensor cores (NVIDIA data sheet), the
#: operations bound's denominators
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _spmv_bytes(A, x, y, *extra) -> int:
    """Bytes an SpMV with ``A`` must move: each nonzero's value and column
    index once (not the padding slots), the ``ncols`` rows of ``x`` (every
    column of these matrices holds a nonzero; a remote part's compressed
    halo holds only such columns), the ``nrows`` rows of ``y`` and each
    tensor of ``extra`` (``y_in``, the dots) once."""
    b = x.shape[1] if x.ndim == 2 else 1
    nz = A.nnz * (A.vals.element_size() + A.cols.element_size())
    return (nz + A.ncols * b * x.element_size()
            + A.nrows * b * y.element_size() + _nbytes(*extra))


def _stored_bytes(A) -> int:
    """The bytes of ``A``'s SELL-C-sigma arrays, padding slots included."""
    return _nbytes(A.vals, A.cols, A.chunk_off, A.chunk_len)


def phase_tsm_timing(fw, card):
    """B2 and B3 at the block-CG shapes (n rows, width 16): kernel, plain
    version and one PyTorch call computing the same function."""
    n = fw["A64"].nrows_pad
    rows = {}
    gains = []
    for dt in (torch.float64, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(6)
        V, W = (torch.randn(n, WIDTH, generator=g, dtype=dt, device="cuda")
                for _ in range(2))
        X = torch.randn(WIDTH, WIDTH, generator=g, dtype=dt, device="cuda")
        Vd, Wd, Xd = V.double(), W.double(), X.double()
        flops = 2.0 * n * WIDTH * WIDTH
        vw, vx = Vd.abs().T @ Wd.abs(), Vd.abs() @ Xd.abs()
        d2 = summation_depth(n, WIDTH, WIDTH)
        # (..., oracle, sum |terms|, summation depth, oracle's depth)
        cases = [
            ("tsmttsm", "kahan", lambda: tsmttsm(V, W, kahan=True),
             lambda: tsmttsm_ref(V, W, kahan=True),
             lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0),
             lambda: tsmttsm_ref(Vd, Wd), (V, W), vw,
             kahan_depth(n, WIDTH, WIDTH, dt), n),
            ("tsmttsm", "plain sum", lambda: tsmttsm(V, W),
             lambda: tsmttsm_ref(V, W),
             lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0),
             lambda: tsmttsm_ref(Vd, Wd), (V, W), vw, d2, n),
            ("tsmm", "with W", lambda: tsmm(V, X, W, 1.0, 1.0),
             lambda: tsmm_ref(V, X, W, 1.0, 1.0),
             lambda: torch.addmm(W, V, X, beta=1.0, alpha=1.0),
             lambda: tsmm_ref(Vd, Xd, Wd, 1.0, 1.0), (V, X, W),
             vx + Wd.abs(), WIDTH, WIDTH),
            ("tsmm", "without W", lambda: tsmm(V, X), lambda: tsmm_ref(V, X),
             lambda: torch.mm(V, X), lambda: tsmm_ref(Vd, Xd), (V, X), vx,
             WIDTH, WIDTH),
        ]
        errs = {}
        for (name, variant, kern, plain, lib, oracle, inputs, scale, depth,
             n_plain) in cases:
            got = kern()
            abs_err = _tsm_check(got, oracle(), scale, dt, depth, n_plain,
                                 f"{name} {variant} {str(dt)[6:]} n={n}")
            if name == "tsmttsm":
                errs[variant == "kahan"] = [abs_err]
            err = float(abs_err.max())
            ms = time_ms(kern)
            slow = variant == "kahan"            # a Python loop over blocks
            plain_ms = time_ms(plain, warmup=1 if slow else 3,
                               iters=2 if slow else 20)
            lib_ms = time_ms(lib)
            # bytes: each input read once, the result written once
            nbytes = _nbytes(*inputs, got)
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * flops / PEAK_FLOPS[dt]
            bound_ms = max(bytes_ms, ops_ms)
            print(f"[timing] {name} {variant} {str(dt)[6:]} n={n} m=k={WIDTH}:"
                  f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB; operations {ops_ms:.4f} ms), "
                  f"{100 * bound_ms / ms:.1f}% of bound, max abs err "
                  f"{err:.3e}  [{card}]")
            rows[(name, variant, dt)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                err=err)
            if name == "tsmttsm" and dt == torch.float32 and len(errs) == 2:
                gains.append(f"[timing] tsmttsm float32 n={n}: "
                             + _require_kahan_gain(errs, "main shape"))
    print("\n".join(gains))
    return rows


def phase_block_split(fw, bcg, tsm, card) -> None:
    """Where one full-width block-CG iteration goes: each component timed
    alone at the iteration's shapes (CUDA events), times its count per
    iteration, against the measured ms per iteration.  B1 at this width is
    held against its plain version first."""
    op, st = bcg["op"], bcg["state"]
    P = st.p
    T = op.mv(P)
    e = rel_err(T, sellcs_spmv_ref(fw["A64"], P)[0])
    print(f"[block cg split] sellcs_spmv b={WIDTH} f64 against plain: max rel "
          f"err {e:.3e} (at most {TOL[torch.float64]['vec']})")
    require(e <= TOL[torch.float64]["vec"],
            f"sellcs_spmv b={WIDTH}: rel err {e:.3e} against plain")
    G = block._herm(tsmttsm(P, T, kahan=True))
    eye = torch.eye(WIDTH, dtype=G.dtype, device=G.device)
    rel = 2.0 ** -52 * WIDTH

    def small():
        gamma = block._spd_solve(G, eye)
        tr, rho = block.svqb_factors(G, rel_eps=rel)
        return gamma @ st.cmat, rho @ st.cmat, rho.conj().T

    # the eigensolver at this shape against torch.linalg.eigh (its plain
    # version and the one PyTorch call for the same function)
    Gs = block._herm(G)
    worst = [0.0, ""]
    _eig_check(Gs, f"block CG Gram m={WIDTH}", worst)
    eig_err = float((herm_eig(Gs)[0] - torch.linalg.eigvalsh(Gs)).abs().max())
    eig_ms = time_ms(lambda: herm_eig(Gs), warmup=5, iters=50)
    eigh_ms = time_ms(lambda: torch.linalg.eigh(Gs), warmup=5, iters=50)
    sweeps = int(herm_eig_cuda(Gs)[2]) if DEVICE == "cuda" else 0
    mp = WIDTH + WIDTH % 2
    bound_ms, by, ops_ms, bytes_ms = eig_bound(WIDTH)
    print(f"[block cg split] herm_eig f64 m={WIDTH} (the Gram of this "
          f"iteration): kernel {eig_ms:.4f} ms, torch.linalg.eigh "
          f"{eigh_ms:.4f} ms, bound {bound_ms:.6f} ms (operations "
          f"{ops_ms:.6f} ms for 9 m^3 flops at DMMA's rate, bytes "
          f"{bytes_ms:.6f} ms); latency: {sweeps} sweeps, a chain of "
          f"{sweeps * (mp - 1)} dependent rounds; within {worst[0]:.3f} of "
          f"its bounds against eigh  [{card}]")
    f64 = torch.float64
    parts = [
        ("sellcs_spmv (b=16)", 1, time_ms(lambda: op.mv(P))),
        ("tsmttsm kahan", 2, tsm[("tsmttsm", "kahan", f64)]["ms"]),
        ("tsmm with W", 3, tsm[("tsmm", "with W", f64)]["ms"]),
        ("tsmm without W", 1, tsm[("tsmm", "without W", f64)]["ms"]),
        ("(b, b) algebra", 1, time_ms(small, warmup=5, iters=50)),
    ]
    total = bcg["ms_iter"]
    rest = total - sum(k * ms for _, k, ms in parts)
    print(f"[block cg split] one iteration = {total:.3f} ms (laplace3d({NX}) "
          f"f64, width {WIDTH})  [{card}]")
    for name, k, ms in parts:
        print(f"[block cg split]   {name:20s} {k} x {ms:.4f} ms = "
              f"{k * ms:.4f} ms ({100 * k * ms / total:.1f}%)")
    print(f"[block cg split]   {'rest':20s} {rest:.4f} ms "
          f"({100 * rest / total:.1f}%): vector arithmetic and launches "
          f"(the (b, b) algebra's two herm_eig calls are in its line)")
    return dict(ms=eig_ms, plain_ms=eigh_ms, library_ms=eigh_ms,
                bound_ms=bound_ms, bound_by=by, err=eig_err)


# ----------------------------------------------------------------- phase 12
#: (blocks dtype, x dtype) of the B4 grid: four dtypes and one mixed pair
B4_PAIRS = ((torch.float64, torch.float64), (torch.float32, torch.float32),
            (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
            (torch.bfloat16, torch.float32))


def _unit(dt) -> float:
    """Unit roundoff of ``dt``'s accumulation dtype."""
    return 2.0 ** -53 if dt == torch.float64 else 2.0 ** -24


def _b4_check(blocks, x, tag, worst):
    """B4 against its plain version computed in float64 from the same
    inputs.  A row sums ``bs`` products in order, so it errs by at most
    ``(bs + 2) u_acc sum_j |B_ij| |x_jc|`` (the products' rounding
    included), plus the float64 plain version's ``(bs + 2) 2^-53`` of the
    same sum, plus the output's own rounding (relative, or one subnormal
    spacing near zero).  Returns the worst ratio of error to bound and the
    largest error."""
    got = block_jacobi_apply(blocks, x)
    bs = blocks.shape[1]
    out = torch.promote_types(blocks.dtype, x.dtype)
    x2 = x if x.ndim == 2 else x[:, None]
    want = block_diag_matmul_ref(blocks.double(), x2.double())
    scale = block_diag_matmul_ref(blocks.double().abs(), x2.double().abs())
    if x.ndim == 1:
        want, scale = want[:, 0], scale[:, 0]
    require(got.dtype == out and got.shape == want.shape,
            f"B4 {tag}: got {tuple(got.shape)} {got.dtype}")
    fi = torch.finfo(out)
    lim = ((bs + 2) * (_unit(out) + 2.0 ** -53) * scale
           + _OUT_UNIT[out] * want.abs() + fi.tiny * fi.eps)
    err = (got.double() - want).abs()
    if err.numel() == 0:
        return 0.0
    ratio, emax = float((err / lim).max()), float(err.max())
    require(ratio <= 1.0, f"B4 {tag}: error {emax:.3e} above its bound "
                          f"({ratio:.2f}x)")
    if ratio >= worst[0]:
        worst[:] = [ratio, tag, emax]
    return emax


def phase_b4_grid() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(7)
    worst = {}
    n_cases = 0
    for bd, xd in B4_PAIRS:
        key = f"{str(bd)[6:]} x {str(xd)[6:]}"
        w = worst.setdefault(key, [0.0, "", 0.0])
        for bs in B4_BS:
            for nb in B4_NB:
                blocks = torch.randn(nb, bs, bs, generator=g,
                                     dtype=torch.float64,
                                     device=DEVICE).to(bd)
                for b in B4_B:
                    x = torch.randn(nb * bs, b, generator=g,
                                    dtype=torch.float64, device=DEVICE).to(xd)
                    _b4_check(blocks, x, f"{key} bs={bs} nb={nb} b={b}", w)
                    n_cases += 1
                x = torch.randn(nb * bs, generator=g, dtype=torch.float64,
                                device=DEVICE).to(xd)
                _b4_check(blocks, x, f"{key} bs={bs} nb={nb} 1-d", w)
                n_cases += 1
    sync()
    for key, (ratio, tag, err) in worst.items():
        print(f"[b4 grid] {key:19s} worst error {err:.3e} = {ratio:.3f} of "
              f"its bound  (at {tag})")
    print(f"[b4 grid] {n_cases} cases within the bound (bs + 2)(u_acc + "
          f"2^-53) sum|B||x| + u_out |y|: bs in {B4_BS}, b in {B4_B} and "
          f"1-d, nblocks in {B4_NB}")


def _b5_check(x, y, a, b, flags, tag, worst, twice=False):
    """B5 against its plain version computed in float64 from the same
    inputs (``a``/``b`` as the kernel sees them, in the accumulation
    dtype).  ``y'`` errs by at most ``3 u_acc (|a x| + |b y|)`` plus the
    output's rounding; each dot by at most ``(depth + 6) u_acc`` times the
    sum of its terms' magnitudes (``depth`` the kernel's longest addition
    chain, ``fused_update.summation_depth``) plus the float64 plain
    version's ``(n + 6) 2^-53`` of the same sum.  With ``twice`` a second
    call must give the same bits."""
    out = torch.promote_types(x.dtype, y.dtype)
    acc = torch.float64 if out == torch.float64 else torch.float32
    n, bw = x.shape
    av = fused_update.coefficients(a, bw, acc, DEVICE).double()
    bv = fused_update.coefficients(b, bw, acc, DEVICE).double()
    got, dots = fused_axpby_dots(x, y, a, b, dot_yy=flags[0],
                                 dot_xy=flags[1], dot_xx=flags[2])
    if twice:
        _b5_same_twice(got, dots, x, y, a, b, flags, tag)
    xd, yd = x.double(), y.double()
    want, wdots = fused_axpby_dots_ref(xd, yd, av, bv, dot_yy=flags[0],
                                       dot_xy=flags[1], dot_xx=flags[2])
    require(got.dtype == out and got.shape == want.shape,
            f"B5 {tag}: got {tuple(got.shape)} {got.dtype}")
    u = _unit(out)
    mag = av.abs() * xd.abs() + bv.abs() * yd.abs()
    fi = torch.finfo(out)
    lim = 3 * u * mag + _OUT_UNIT[out] * want.abs() + fi.tiny * fi.eps
    ratio = float((((got.double() - want).abs()) / lim).max()) if n else 0.0
    require(ratio <= 1.0, f"B5 {tag}: y' error {ratio:.2f}x its bound")
    if not any(flags):
        require(dots is None, f"B5 {tag}: dots without a flag")
    else:
        require(dots is not None and dots.dtype == acc
                and dots.shape == (3, bw), f"B5 {tag}: dots {dots}")
        depth = fused_update.summation_depth(n, bw, out)
        scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                             (xd * xd).sum(0)])
        dlim = ((depth + 6) * u + (n + 6) * 2.0 ** -53) * scale + 1e-300
        derr = (dots.double() - wdots).abs()
        r2 = float((derr / dlim).max())
        require(r2 <= 1.0, f"B5 {tag}: dots error {float(derr.max()):.3e} "
                           f"{r2:.2f}x their bound")
        ratio = max(ratio, r2)
    if ratio >= worst[0]:
        worst[:] = [ratio, tag]


def _b5_same_twice(got, dots, x, y, a, b, flags, tag):
    again, dots2 = fused_axpby_dots(x, y, a, b, dot_yy=flags[0],
                                    dot_xy=flags[1], dot_xx=flags[2])
    require(torch.equal(got, again) and (dots is None) == (dots2 is None)
            and (dots is None or torch.equal(dots, dots2)),
            f"B5 {tag}: a second call differs in its bits")


B5_FLAGS = tuple((yy, xy, xx) for yy in (False, True) for xy in (False, True)
                 for xx in (False, True))


def phase_b5_grid() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(8)
    worst = {}
    n_cases = 0
    shapes = ([(n, bw) for n in B5_NS for bw in B5_BW]
              + [(n, bw) for n in B5_WIDE_NS for bw in B5_WIDE_BW])
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        w = worst.setdefault(str(dt)[6:], [0.0, ""])
        for n, bw in shapes:
            x, y = (torch.randn(n, bw, generator=g, dtype=torch.float64,
                                device=DEVICE).to(dt) for _ in range(2))
            coefs = [(0.75, -1.25, "scalar"),
                     (torch.randn(bw, generator=g, dtype=torch.float64,
                                  device=DEVICE),
                      torch.randn(bw, generator=g, dtype=torch.float64,
                                  device=DEVICE), "per-column")]
            for a, b, kind in coefs:
                for flags in B5_FLAGS:
                    _b5_check(x, y, a, b, flags,
                              f"{str(dt)[6:]} n={n} bw={bw} {kind} "
                              f"dots={flags}", w,
                              twice=bw in B5_WIDE_BW)
                    n_cases += 1
        x1, y1 = (torch.randn(4109, generator=g, dtype=torch.float64,
                              device=DEVICE).to(dt) for _ in range(2))
        out, dots = fused_axpby_dots(x1, y1, 2.0, 0.5, dot_yy=True,
                                     dot_xy=True, dot_xx=True)
        want, wdots = fused_axpby_dots(x1[:, None], y1[:, None], 2.0, 0.5,
                                       dot_yy=True, dot_xy=True, dot_xx=True)
        require(out.shape == (4109,) and dots.shape == (3,)
                and torch.equal(out, want[:, 0])
                and torch.equal(dots, wdots[:, 0]),
                f"B5 1-d {dt}: differs from the (n, 1) call")
        n_cases += 1
    sync()
    for key, (ratio, tag) in worst.items():
        print(f"[b5 grid] {key:9s} worst error = {ratio:.3f} of its bound  "
              f"(at {tag})")
    print(f"[b5 grid] {n_cases} cases within their bounds (y': 3 u_acc "
          f"(|a x| + |b y|) + u_out |y'|; dots: (depth + 6) u_acc sum|terms|):"
          f" n in {B5_NS}, bw in {B5_BW}, and n in {B5_WIDE_NS}, bw in "
          f"{B5_WIDE_BW} (each twice, bit-equal), scalar and per-column a/b, "
          f"every combination of the dot flags, and 1-d inputs")


# ----------------------------------------------------------------- phase 13
def _aniso(nx: int):
    r, c, v, n = anisotropic_laplace2d(nx, epsilon=PRECOND_EPS)
    t0 = time.perf_counter()
    A = from_coo(r, c, v, (n, n), C=PRECOND_C, sigma=1, dtype=np.float64,
                 device=DEVICE)
    sync()
    print(f"[precond] anisotropic_laplace2d({nx}, eps={PRECOND_EPS}) n={n} "
          f"nnz={A.nnz} C={PRECOND_C} sigma=1: f64 build "
          f"{time.perf_counter() - t0:.1f} s")
    return A


def phase_precond_cg(card):
    """Slice 4's main path: block-Jacobi preconditioned CG at full width."""
    A = _aniso(PRECOND_NX)
    op = make_operator(A)
    # the host set-up as a user makes it: extraction and factorization on
    # the host, then the copy of the inverses to the card
    t0 = time.perf_counter()
    M = make_preconditioner("block_jacobi", matrix=A)
    sync()
    t_setup = time.perf_counter() - t0
    print(f"[pcg] host set-up: make_preconditioner('block_jacobi') "
          f"{t_setup:.2f} s (bs = {M.block_size}, "
          f"{M.inv_blocks.shape[0]} blocks, "
          f"{M.inv_blocks.numel() * 8 / 1e9:.3f} GB of f64 inverses on the "
          f"card)")
    g = torch.Generator(device=DEVICE).manual_seed(9)
    b = A.permute(torch.randn(A.nrows, PRECOND_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    maxiter = 8 * A.nrows
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=PCG_TOL, maxiter=maxiter, M=M)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(PRECOND_KERNELS)
    it = res.iters
    d = dropped("cg_precond")
    relres = _colwise_relres(A, b, res.x)
    ms_iter = 1e3 * secs / max(it, 1)
    print(f"[pcg] block_jacobi PCG f64 b={PRECOND_WIDTH} tol {PCG_TOL}: {it} "
          f"iterations in {secs:.3f} s ({ms_iter:.3f} ms/iter), converged="
          f"{bool(res.converged.all())}  [{card}]")
    print(f"[pcg] true relative residual per column: "
          f"{' '.join(f'{r:.2e}' for r in relres.tolist())}")
    print(f"[pcg] launches {launches} (per iteration 1 sellcs_spmv and 1 "
          f"block_diag_matmul; cg_init 1 each; {d} discarded iteration)")
    require(bool(res.converged.all()), "PCG: not converged")
    require(float(relres.max()) <= 10 * PCG_TOL,
            f"PCG: true residual {float(relres.max())} > {10 * PCG_TOL}")
    require(d <= 1, f"PCG: {d} discarded iterations in one chunk")
    want = {"sellcs_spmv": it + d + 1, "block_diag_matmul": it + d + 1}
    require(launches == want or DEVICE == "cpu",
            f"PCG launches {launches} != {want}")

    # cg_step chunks of 256 must equal the monolithic solve bit for bit
    st = cg_init(op, b, tol=PCG_TOL, maxiter=maxiter, M=M)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 256, M=M)
    ch = cg_finalize(st)
    same = (ch.iters == it and torch.equal(ch.x, res.x)
            and torch.equal(ch.resnorm, res.resnorm))
    print(f"[pcg] as cg_step chunks of 256: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked PCG differs from the monolithic one")

    # plain CG on the same right-hand sides: sweeps and time to solution
    sync()
    t0 = time.perf_counter()
    plain = cg(op, b, tol=PCG_TOL, maxiter=maxiter)
    sync()
    plain_secs = time.perf_counter() - t0
    prel = _colwise_relres(A, b, plain.x)
    print(f"[pcg] plain CG on the same rhs: {plain.iters} iterations in "
          f"{plain_secs:.3f} s ({1e3 * plain_secs / max(plain.iters, 1):.3f}"
          f" ms/iter), converged={bool(plain.converged.all())}, max true "
          f"relative residual {float(prel.max()):.2e}; PCG takes "
          f"{plain.iters / max(it, 1):.2f}x fewer iterations and "
          f"{plain_secs / secs:.2f}x less time  [{card}]")
    require(bool(plain.converged.all()), "plain CG: not converged")
    return dict(A=A, op=op, M=M, b=b, res=res, iters=it, secs=secs,
                ms_iter=ms_iter, launches=launches, state=st,
                plain_iters=plain.iters, plain_secs=plain_secs)


# ---------------------------------------------------------------- phase 13b
#: slice 15: complex values on the card.  The dtypes, B1's chunk heights
#: and widths, B2/B3's row counts and widths, B4's block sizes, widths and
#: block counts in the grid; the seed of the U(1) phases; the phased
#: matrices (phase 6's laplace3d(NX), C=32, sigma=1024; anisotropic_laplace2d
#: (CX_PRECOND_NX), C=32, sigma=1, block-Jacobi bs 32); the block width,
#: Lanczos steps and tolerances of the complex solves
CX_DTYPES = (torch.complex128, torch.complex64)
CX_REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}
CX_GRID_C, CX_GRID_B = (8, 32), (1, 2, 4, 8, 16)
#: a chunk taller than a block's threads (walked in passes; with dots,
#: complex64 at 512 threads needs more than 48 KB of shared memory)
CX_GRID_TALL_C, CX_GRID_TALL_B = 256, (4, 16)
CX_TSM_NS, CX_TSM_DIMS = (37, 4109, 1 << 18), (1, 5, 16, NARROW)
#: B2 on views one element off the allocation (complex64: off a 16-byte
#: boundary, so the stages fill by plain loads), held bit for bit to the
#: same values in a fresh tensor; and the phased laplace3d of the complex
#: block CG run in cg_step chunks against one monolithic solve
CX_TSM_VIEWS = ((5, 16), (16, 5), (16, 16), (1, NARROW), (NARROW, 3))
CX_CHUNK_NX, CX_CHUNK_STEPS = 12, 3
#: B1's timed complex widths, and those timed with <p, Ap> (column CG and
#: PCG at 4, Lanczos at 1; ChebFD's block of 8 and block CG's 16 ask none)
CX_TIMED_B, CX_TIMED_DOTS = (1, 4, 8, 16), (1, 4)
#: B3's template widths (m = k) that CX_TSM_DIMS leaves out
CX_TSMM_SQUARES = (2, 4, 8, 32)
#: B5's complex grid: widths and dot flags (its row counts are 0, 1 and
#: CX_TSM_NS)
CX_B5_BW = (1, 4, 16, 86, 256)
CX_B5_FLAGS = ((False, False, False), (True, True, True), (False, True, False))
CX_TSM_COEFS = ((1.0, 0.0, False), (0.5 - 0.5j, -2.0 + 1.0j, True))
CX_B4_BS, CX_B4_B, CX_B4_NB = (8, 32), (1, 4, 16), (1, 4096, 32768)
CX_SEED, CX_PRECOND_NX, CX_WIDTH, CX_LANCZOS_K = 15, 1024, 16, 30
CX_TOL = {torch.complex128: 1e-8, torch.complex64: 1e-5}
CX_LANCZOS_TOL, CX_ENGINE_TOL = 1e-10, 1e-12
#: complex ChebFD, KPM and pipelined CG on the phased laplace3d(NX): the
#: reference lambda_min from an unreorthogonalised Lanczos of this many
#: steps (k = 30 is 5e-2 off there; 120 with reorthogonalisation and 200
#: and 300 without agree within 6e-11), ChebFD's window (lambda_min - 0.05,
#: lambda_min + 0.01) (the next eigenvalue lies 0.022 above), its degree
#: and sweeps, and the gates: ChebFD's lowest Ritz value within 1e-8
#: relative of lambda_min; KPM's mu_2 (a float32 moment) within 4 float32
#: roundings of 2||A_s v||^2 + ||v||^2 of the exact value; pipelined CG
#: in at most plain CG's count + 2
CX_REF_LANCZOS_K, CX_CHEB_BELOW, CX_CHEB_ABOVE = 200, 0.05, 0.01
CX_CHEB_DEGREE, CX_CHEB_SWEEPS, CX_CHEB_TOL = 200, 4, 1e-8
CX_KPM_MOMENTS, CX_KPM_PROBES = 8, 4
#: the H100's measured device-memory rate (``launch/mesh.py:HW``): the
#: complex rows print their bound at it too, as a second figure beside the
#: one at :data:`HBM_BYTES_PER_S` that every row is held to
CX_MEASURED_BYTES_PER_S = MESH_HW["hbm_bw"]


def phased(r, c, v, n: int, seed: int) -> np.ndarray:
    """Complex Hermitian values from a symmetric COO with nonpositive
    off-diagonals: ``H_ij = L_ij exp(i theta_ij)``, ``theta_ji =
    -theta_ij``, drawn from ``default_rng(seed)`` over the upper triangle
    in COO order, ``H_ii = L_ii``.  Then ``x^H H x >= |x|^T L |x|``, so
    lambda_min(H) >= lambda_min(L) > 0 (Kato's inequality)."""
    r, c = np.asarray(r, np.int64), np.asarray(c, np.int64)
    up, lo = r < c, r > c
    theta_up = np.random.default_rng(seed).uniform(0.0, 2 * np.pi,
                                                   int(up.sum()))
    key = r[up] * n + c[up]
    order = np.argsort(key)
    want = c[lo] * n + r[lo]
    at = np.searchsorted(key, want, sorter=order)
    pos = order[np.minimum(at, order.size - 1)]
    require(bool(np.all(key[pos] == want)), "phased: the pattern is not "
            "symmetric")
    theta = np.zeros(r.size)
    theta[up] = theta_up
    theta[lo] = -theta_up[pos]
    return np.asarray(v, np.float64) * np.exp(1j * theta)


def _cx_randn(shape, dt, g):
    """Complex (or real) normal numbers drawn in float64 and rounded."""
    wide = torch.complex128 if dt.is_complex else torch.float64
    return torch.randn(*shape, generator=g, dtype=wide, device=DEVICE).to(dt)


def _cx_flag_cases(b: int, rng, np_ct):
    gam = (rng.standard_normal(b) + 1j * rng.standard_normal(b)).astype(np_ct)
    return [
        ("plain", SpmvOpts(), False, False),
        ("alpha_beta", SpmvOpts(alpha=0.7 - 0.2j, beta=-1.3 + 0.4j), True,
         False),
        ("gamma_scalar", SpmvOpts(alpha=1.2 + 0.5j, gamma=0.25 - 0.75j),
         False, False),
        ("gamma_column", SpmvOpts(gamma=gam), True, False),
        ("chain", SpmvOpts(alpha=1.1j, beta=0.5, delta=0.3 - 0.1j,
                           eta=-0.8 + 0.6j), True, True),
        ("dots", SpmvOpts(alpha=0.9 + 0.1j, beta=0.4j, dot_yy=True,
                          dot_xy=True, dot_xx=True), True, False),
    ]


def _cx_check(got, want, scale, dt, depth, n_plain, tag, worst):
    """A complex result against its plain version in complex128.  Each
    part of a complex sum of ``d`` products is a real sum of ``2 d``
    products (with the fused multiply-adds' rounding), and |re| + |im|
    of the terms is at most sqrt(2) |a| |b|: the real kernels' bound
    ``(depth + 3) u sum|terms|`` becomes ``sqrt(2) (2 depth + 3) u sum
    |a||b|`` on the modulus, plus the plain version's own in 2^-53, plus
    one subnormal spacing near zero."""
    require(got.shape == want.shape and got.dtype == dt,
            f"{tag}: got {tuple(got.shape)} {got.dtype}")
    fi = torch.finfo(CX_REAL[dt])
    lim = (2.0 ** 0.5 * ((2 * depth + 3) * _ACC_UNIT[CX_REAL[dt]]
                         + (2 * n_plain + 3) * 2.0 ** -53) * scale
           + fi.tiny * fi.eps)
    err = (got.to(torch.complex128) - want).abs()
    if err.numel() == 0:
        return 0.0
    ratio, emax = float((err / lim).max()), float(err.max())
    require(ratio <= 1.0, f"{tag}: error {emax:.3e} above its bound "
                          f"({ratio:.2f}x)")
    if ratio >= worst[0]:
        worst[:] = [ratio, tag, emax]
    return emax


def phase_complex_grid() -> None:
    """B1–B4 with complex64 and complex128 operands against their plain
    versions on the card, each within a stated bound."""
    rng = np.random.default_rng(15)
    g = torch.Generator(device=DEVICE).manual_seed(15)
    t0 = time.perf_counter()
    n_cases = 0
    for ct in CX_DTYPES:
        np_ct = np.complex128 if ct == torch.complex128 else np.complex64
        rt = CX_REAL[ct]
        tol = TOL[rt]
        worst = {}
        for C in CX_GRID_C + (CX_GRID_TALL_C,):
            n = 16 * C + 5                        # ragged last chunk
            rows, cols, vals = _grid_coo(n, n, rng)
            vals = vals + 1j * rng.standard_normal(vals.size)
            A = from_coo(rows, cols, vals, (n, n), C=C, sigma=4 * C,
                         dtype=np_ct, device=DEVICE)
            for b in CX_GRID_B if C in CX_GRID_C else CX_GRID_TALL_B:
                x, y, z = (_cx_randn((A.nrows_pad, b), ct, g)
                           for _ in range(3))
                for name, opts, with_y, with_z in _cx_flag_cases(b, rng,
                                                                 np_ct):
                    args = (A, x, y if with_y else None,
                            z if with_z else None, opts)
                    tag = f"{str(ct)[6:]} C={C} b={b} {name}"
                    _compare(*args, tol, tag, worst.setdefault(name, [0.0, ""]))
                    # the same call again: the same bits (a fixed order of
                    # every sum, the dots' included)
                    one, two = sellcs_spmv(*args), sellcs_spmv(*args)
                    require(all((u is None and v is None) or torch.equal(u, v)
                                for u, v in zip(one, two)),
                            f"complex grid {tag}: two runs differ")
                    n_cases += 1
                # a real x of the values' precision: converted exactly
                xr = _cx_randn((A.nrows_pad, b), rt, g)
                opts = SpmvOpts(alpha=0.5 + 1j, dot_xy=True, dot_xx=True,
                                dot_yy=True)
                _compare(A, xr, None, None, opts, tol,
                            f"{str(ct)[6:]} C={C} b={b} real x",
                            worst.setdefault("real_x", [0.0, ""]))
                n_cases += 1
        for name, (err, tag) in worst.items():
            print(f"[complex grid] B1 {str(ct)[6:]:10s} {name:12s} max rel "
                  f"err {err:.3e}  (worst: {tag})")
    print(f"[complex grid] B1: {n_cases} cases within the real kernels' "
          f"tolerances (complex128 as f64 1e-12; complex64 as f32: vectors "
          f"1e-5, dots 1e-6): C in {CX_GRID_C}, b in {CX_GRID_B}; C = "
          f"{CX_GRID_TALL_C}, b in {CX_GRID_TALL_B}; every "
          f"fusion flag with complex alpha/beta/gamma/delta/eta (each run "
          f"twice, bit for bit the same), a real x")

    worst = {}
    n_tsm = 0
    for ct in CX_DTYPES:
        for n in CX_TSM_NS:
            for m in CX_TSM_DIMS:
                for k in CX_TSM_DIMS:
                    V, W, X = (_cx_randn(s, ct, g)
                               for s in ((n, m), (n, k), (m, k)))
                    Vd, Wd, Xd = (t.to(torch.complex128) for t in (V, W, X))
                    vw = Vd.abs().T @ Wd.abs()
                    d2 = summation_depth(n, m, k, ct)
                    for alpha, beta, out in CX_TSM_COEFS:
                        scale = abs(alpha) * vw + abs(beta) * Xd.abs()
                        for conj in (True, False):
                            want = tsmttsm_ref(Vd, Wd, Xd if out else None,
                                               alpha, beta, conj=conj)
                            for kahan in (False, True):
                                got = tsmttsm(V, W, X if out else None,
                                              alpha, beta, kahan=kahan,
                                              conj=conj)
                                depth = (kahan_depth(n, m, k, CX_REAL[ct],
                                                     ct) if kahan else d2)
                                key = (f"B2 {str(ct)[6:]} conj={conj} "
                                       f"kahan={kahan}")
                                _cx_check(got, want, scale, ct, depth, n,
                                          f"{key} n={n} m={m} k={k} "
                                          f"alpha={alpha}",
                                          worst.setdefault(key,
                                                           [0.0, "", 0.0]))
                                n_tsm += 1
                    # B3: W = alpha V X + beta W, X complex and real
                    Xr = _cx_randn((m, k), CX_REAL[ct], g)
                    Ws = _cx_randn((n, k), ct, g)
                    Wsd = Ws.to(torch.complex128)
                    for xlabel, Xs in (("complex X", X), ("real X", Xr)):
                        Xsd = Xs.to(torch.complex128)
                        vx = Vd.abs() @ Xsd.abs()
                        for alpha, beta, out in CX_TSM_COEFS:
                            want = tsmm_ref(Vd, Xsd, Wsd if out else None,
                                            alpha, beta)
                            got = tsmm(V, Xs, Ws if out else None, alpha, beta)
                            key = f"B3 {str(ct)[6:]} {xlabel}"
                            _cx_check(got, want,
                                      abs(alpha) * vx + abs(beta) * Wsd.abs(),
                                      ct, m, m, f"{key} n={n} m={m} k={k} "
                                      f"alpha={alpha}",
                                      worst.setdefault(key, [0.0, "", 0.0]))
                            n_tsm += 1
        for n in CX_TSM_NS:
            for w in CX_TSMM_SQUARES:
                V, W, X = (_cx_randn(sh, ct, g)
                           for sh in ((n, w), (n, w), (w, w)))
                Vd, Wd, Xd = (t.to(torch.complex128) for t in (V, W, X))
                vx = Vd.abs() @ Xd.abs()
                for alpha, beta, out in CX_TSM_COEFS:
                    got = tsmm(V, X, W if out else None, alpha, beta)
                    key = f"B3 {str(ct)[6:]} m=k in {CX_TSMM_SQUARES}"
                    _cx_check(got, tsmm_ref(Vd, Xd, Wd if out else None,
                                            alpha, beta),
                              abs(alpha) * vx + abs(beta) * Wd.abs(), ct,
                              w, w, f"{key} n={n} m=k={w} alpha={alpha}",
                              worst.setdefault(key, [0.0, "", 0.0]))
                    n_tsm += 1
        for bs in CX_B4_BS:
            for nb in CX_B4_NB:
                blocks = _cx_randn((nb, bs, bs), ct, g)
                bd = blocks.to(torch.complex128)
                for b in CX_B4_B:
                    for xlabel, xd in (("complex x", ct),
                                       ("real x", CX_REAL[ct])):
                        x = _cx_randn((nb * bs, b), xd, g)
                        xc = x.to(torch.complex128)
                        got = block_jacobi_apply(blocks, x)
                        want = block_diag_matmul_ref(bd, xc)
                        scale = block_diag_matmul_ref(bd.abs(), xc.abs())
                        key = f"B4 {str(ct)[6:]} {xlabel}"
                        _cx_check(got, want, scale, ct, bs, bs,
                                  f"{key} bs={bs} nb={nb} b={b}",
                                  worst.setdefault(key, [0.0, "", 0.0]))
                        n_tsm += 1
    n_views = _cx_tsm_views(g)
    sync()
    for key, (ratio, tag, err) in worst.items():
        print(f"[complex grid] {key:36s} worst error {err:.3e} = "
              f"{ratio:.3f} of its bound  (at {tag})")
    print(f"[complex grid] B2: {n_views} calls on views one element off "
          f"their allocation (n in {CX_TSM_NS}, (m, k) in {CX_TSM_VIEWS}, "
          f"conj on and off, with and without Kahan) bit for bit equal to "
          f"the same values in fresh tensors")
    _cx_block_chunked(g)
    print(f"[complex grid] B2/B3/B4: {n_tsm} cases within sqrt(2) (2 depth "
          f"+ 3) u sum|a||b| (the real bound per part): B2 n in "
          f"{CX_TSM_NS}, m, k in {CX_TSM_DIMS}, conj on and off, with and "
          f"without Kahan; B3 with complex and real X, and at m = k in "
          f"{CX_TSMM_SQUARES}; B4 bs in {CX_B4_BS}, b in {CX_B4_B}, nblocks "
          f"in {CX_B4_NB}, complex and real x")
    n_b5 = 0
    worst = {}
    for ct in CX_DTYPES:
        w = worst.setdefault(str(ct)[6:], [0.0, ""])
        shapes = ([(n, bw) for n in (0, 1) + tuple(CX_TSM_NS)
                   for bw in CX_B5_BW]
                  + [(n, bw) for n in B5_WIDE_NS for bw in B5_WIDE_BW])
        for n, bw in shapes:
            x, y = (_cx_randn((n, bw), ct, g) for _ in range(2))
            for a, b, kind in ((0.75 - 0.5j, -1.25 + 2j, "scalar"),
                               (_cx_randn((bw,), ct, g),
                                _cx_randn((bw,), ct, g), "per-column")):
                for flags in (B5_FLAGS if bw in B5_WIDE_BW
                              else CX_B5_FLAGS):
                    _b5_cx_check(x, y, a, b, flags,
                                 f"{str(ct)[6:]} n={n} bw={bw} {kind} "
                                 f"dots={flags}", w,
                                 twice=bw in B5_WIDE_BW)
                    n_b5 += 1
        # a real x of the precision: widened exactly, as the plain version
        # promotes it
        xr = _cx_randn((4109, 4), CX_REAL[ct], g)
        y4 = _cx_randn((4109, 4), ct, g)
        _b5_cx_check(xr, y4, 0.5 + 1j, -1.0, (True, True, True),
                     f"{str(ct)[6:]} real x", w)
        n_b5 += 1
    sync()
    for key, (ratio, tag) in worst.items():
        print(f"[complex grid] B5 {key:10s} worst error = {ratio:.3f} of its "
              f"bound  (at {tag})")
    print(f"[complex grid] B5: {n_b5} cases within their bounds (y': 8 u "
          f"(|a||x| + |b||y|); dots: ((depth + 6) 2^-53 + 8 u) sum|terms| "
          f"+ u |dot|): n in {(0, 1) + tuple(CX_TSM_NS)}, bw in {CX_B5_BW}, "
          f"dots {CX_B5_FLAGS}, and n in {B5_WIDE_NS}, bw in {B5_WIDE_BW} "
          f"with every flag (each twice, bit-equal), scalar and per-column "
          f"complex a/b, a real x; {time.perf_counter() - t0:.1f} s in all")


def _cx_tsm_views(g) -> int:
    """B2 on V and W one element off their allocation against the same
    values in fresh tensors: the row partition alone fixes the order of
    the sums, so the bits agree whether the stages fill by bulk copies or
    by plain loads."""
    n_calls = 0
    for ct in CX_DTYPES:
        for n in CX_TSM_NS:
            for m, k in CX_TSM_VIEWS:
                V, W = (_cx_randn(sh, ct, g) for sh in ((n, m), (n, k)))
                Vo, Wo = (torch.empty(t.numel() + 1, dtype=ct,
                                      device=DEVICE)[1:].view(t.shape)
                          for t in (V, W))
                Vo.copy_(V)
                Wo.copy_(W)
                for conj in (True, False):
                    for kahan in (False, True):
                        same = torch.equal(
                            tsmttsm(Vo, Wo, kahan=kahan, conj=conj),
                            tsmttsm(V, W, kahan=kahan, conj=conj))
                        require(same, f"complex grid: B2 {str(ct)[6:]} n={n} "
                                f"m={m} k={k} conj={conj} kahan={kahan} on "
                                f"views differs from fresh tensors")
                        n_calls += 2
    return n_calls


def _cx_block_chunked(g) -> None:
    """Complex block CG (B1, B2, B3 and the eigensolver on its path) in
    cg_step chunks against one monolithic solve, bit for bit: B2's sums
    have a fixed order, so a chunked solve is the monolithic one."""
    r, c, v, n = laplace3d(CX_CHUNK_NX)
    hv = phased(r, c, v, n, CX_SEED + 3)
    for ct, tol in ((torch.complex128, 1e-10), (torch.complex64, 1e-5)):
        A = from_coo(r, c, hv, (n, n), C=32, sigma=64,
                     dtype=np.complex128 if ct == torch.complex128
                     else np.complex64, device=DEVICE)
        op = make_operator(A)
        b = A.permute(_cx_randn((n, CX_WIDTH), ct, g))
        res = cg(op, b, tol=tol, maxiter=500, block=True)
        st = cg_init(op, b, tol=tol, maxiter=500, block=True)
        while st.it < st.maxiter and not bool(st.done.all()):
            st = cg_step(op, st, CX_CHUNK_STEPS)
        ch = cg_finalize(st)
        same = (ch.iters == res.iters and torch.equal(ch.x, res.x)
                and torch.equal(ch.resnorm, res.resnorm))
        print(f"[complex grid] block CG {str(ct)[6:]} on phased laplace3d("
              f"{CX_CHUNK_NX}), width {CX_WIDTH}: {res.iters} iterations; as "
              f"cg_step chunks of {CX_CHUNK_STEPS} bit-identical to the "
              f"monolithic solve: {same}")
        require(bool(res.converged.all()),
                f"complex grid: block CG {ct} not converged")
        require(same, f"complex grid: chunked block CG {ct} differs from "
                      f"the monolithic one")


def _b5_cx_check(x, y, a, b, flags, tag, worst, twice=False):
    """B5's complex variant against its plain version computed in
    complex128 from the same inputs (``a``/``b`` as the kernel sees them).
    Each entry of ``y'`` is a sum of two complex products, each within
    about 2 sqrt(2) u of its magnitude with fused multiply-adds: 8 u
    (|a||x| + |b||y|) bounds it.  The dots sum in complex128: (depth + 6)
    2^-53 of the sum of their terms' magnitudes, plus the terms' own error
    from y' (8 u of the same sum) and, for complex64, the final rounding
    (u |dot|).  With ``twice`` a second call must give the same bits."""
    ct = torch.promote_types(x.dtype, y.dtype)
    n, bw = x.shape
    av = fused_update.coefficients(a, bw, ct, DEVICE).to(torch.complex128)
    bv = fused_update.coefficients(b, bw, ct, DEVICE).to(torch.complex128)
    got, dots = fused_axpby_dots(x, y, a, b, dot_yy=flags[0],
                                 dot_xy=flags[1], dot_xx=flags[2])
    if twice:
        _b5_same_twice(got, dots, x, y, a, b, flags, tag)
    xd, yd = x.to(torch.complex128), y.to(torch.complex128)
    want, wdots = fused_axpby_dots_ref(xd, yd, av, bv, dot_yy=flags[0],
                                       dot_xy=flags[1], dot_xx=flags[2])
    require(got.dtype == ct and got.shape == want.shape,
            f"B5 {tag}: got {tuple(got.shape)} {got.dtype}")
    u = 2.0 ** -53 if ct == torch.complex128 else 2.0 ** -24
    mag = av.abs() * xd.abs() + bv.abs() * yd.abs()
    lim = 8 * u * mag + 1e-300
    err = (got.to(torch.complex128) - want).abs()
    ratio = float((err / lim).max()) if n else 0.0
    require(ratio <= 1.0, f"B5 {tag}: y' error {ratio:.2f}x its bound")
    if not any(flags):
        require(dots is None, f"B5 {tag}: dots without a flag")
    else:
        require(dots is not None and dots.dtype == ct
                and dots.shape == (3, bw), f"B5 {tag}: dots {dots}")
        depth = fused_update.summation_depth(n, bw, ct)
        scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                             (xd.abs() ** 2).sum(0)])
        dlim = (((depth + 6) * 2.0 ** -53 + 8 * u) * scale
                + u * wdots.abs() + 1e-300)
        derr = (dots.to(torch.complex128) - wdots).abs()
        r2 = float((derr / dlim).max())
        require(r2 <= 1.0, f"B5 {tag}: dots error {float(derr.max()):.3e} "
                           f"{r2:.2f}x their bound")
        ratio = max(ratio, r2)
    if ratio >= worst[0]:
        worst[:] = [ratio, tag]


#: the eigensolver's grid: dtypes, orders and kinds of Hermitian matrix
EIG_DTYPES = (torch.float64, torch.float32, torch.complex128,
              torch.complex64)
EIG_MS = (1, 2, 3, 16, 17, NARROW)
EIG_KINDS = ("gram", "rank deficient", "repeated")


def _eig_matrix(kind, m, dt, g):
    """A Hermitian (m, m) matrix in ``dt`` built in its wide dtype: a
    random Gram matrix, a Gram of rank m // 2, or two eigenvalues (1 and
    2) of multiplicity about m / 2."""
    wide = torch.complex128 if dt.is_complex else torch.float64
    X = torch.randn(m, m, generator=g, dtype=wide, device=DEVICE)
    if kind == "gram":
        A = X @ X.mH
    elif kind == "rank deficient":
        A = X[:, :m // 2] @ X[:, :m // 2].mH
    else:
        Q, _ = torch.linalg.qr(X)
        d = torch.where(torch.arange(m, device=DEVICE) < m // 2, 1.0, 2.0)
        A = (Q * d.to(wide)) @ Q.mH
    return (0.5 * (A + A.mH)).to(dt)


def _eig_check(A, tag, worst):
    """The eigensolver against ``torch.linalg.eigh`` in the wide dtype on
    the same matrix: eigenvalues within 4 m eps ||A||_F, ||A U - U W||_F
    within 16 m eps ||A||_F, ||U^H U - I||_F within 16 m eps (eps the
    machine epsilon of A's real dtype), the flag set.  U is not compared
    entry by entry: it is fixed only up to phases and within repeated
    eigenvalues' spaces.  Returns the largest share of a bound."""
    m = A.shape[-1]
    wide = torch.complex128 if A.is_complex() else torch.float64
    w, U, conv = herm_eig(A)
    real = A.real.dtype if A.is_complex() else A.dtype
    require(w.dtype == real and U.dtype == A.dtype and bool(conv),
            f"herm_eig {tag}: {w.dtype} {U.dtype} converged={bool(conv)}")
    eps = torch.finfo(real).eps
    Ad = A.to(wide)
    norm = float(torch.linalg.norm(Ad)) + 1e-300
    ref = torch.linalg.eigvalsh(Ad)
    Ud, wd = U.to(wide), w.to(wide)
    eye = torch.eye(m, dtype=wide, device=A.device)
    shares = (float((w.double() - ref).abs().max()) / (4 * m * eps * norm),
              float(torch.linalg.norm(Ad @ Ud - Ud * wd[None, :]))
              / (16 * m * eps * norm),
              float(torch.linalg.norm(Ud.mH @ Ud - eye)) / (16 * m * eps))
    require(bool(torch.all(w[1:] >= w[:-1])),
            f"herm_eig {tag}: eigenvalues not ascending")
    require(max(shares) <= 1.0, f"herm_eig {tag}: eigenvalues, residual, "
            f"orthogonality at {shares} of their bounds")
    if max(shares) >= worst[0]:
        worst[:] = [max(shares), tag]
    return max(shares)


def phase_eig_grid() -> None:
    """The eigensolver (the port's own kernel, ``csrc/herm_eig.cu``)
    against ``torch.linalg.eigh`` over dtypes, orders and kinds of
    matrix, one at a time and as a batch, with no host synchronisation
    in the call."""
    g = torch.Generator(device=DEVICE).manual_seed(26)
    worst, n_cases = {}, 0
    for dt in EIG_DTYPES:
        w = worst.setdefault(str(dt)[6:], [0.0, ""])
        for m in EIG_MS:
            for kind in EIG_KINDS:
                _eig_check(_eig_matrix(kind, m, dt, g),
                           f"{str(dt)[6:]} m={m} {kind}", w)
                n_cases += 1
        batch = torch.stack([_eig_matrix("gram", WIDTH, dt, g)
                             for _ in range(8)])
        wb, Ub, cb = herm_eig(batch)
        for i in range(batch.shape[0]):
            wi, Ui, _ = herm_eig(batch[i])
            require(torch.equal(wi, wb[i]) and torch.equal(Ui, Ub[i]),
                    f"herm_eig {dt}: a batch differs from one at a time")
        n_cases += 1
    if DEVICE == "cuda":
        A = _eig_matrix("gram", WIDTH, torch.float64, g)
        sync()
        syncs = _syncs(lambda: herm_eig(A))
        print(f"[eig grid] synchronising calls in one herm_eig call: {syncs}; "
              f"in one torch.linalg.eigh call: "
              f"{_syncs(lambda: torch.linalg.eigh(A))}")
        require(syncs == 0, f"herm_eig: {syncs} synchronising calls")
    sync()
    for key, (ratio, tag) in worst.items():
        print(f"[eig grid] {key:10s} worst = {ratio:.3f} of its bounds  "
              f"(at {tag})")
    print(f"[eig grid] {n_cases} cases within their bounds (eigenvalues 4 m "
          f"eps ||A||_F of eigh's in float64/complex128, ||AU - UW||_F and "
          f"||U^H U - I||_F 16 m eps): dtypes "
          f"{[str(d)[6:] for d in EIG_DTYPES]}, m in {EIG_MS}, {EIG_KINDS}, "
          f"and a batch of 8 at m = {WIDTH} equal to one at a time")


# ---------------------------------------------------------------- phase 12b
#: slice 19: every kernel past its narrow design (the instances that used
#: to raise).  B2/B3's widths (m, k), row counts and dtypes; the
#: eigensolver's orders (all four dtypes) and one float64 order whose A
#: lives in device memory; B1's chunk heights (None: one chunk of all
#: rows, ELLPACK), the rows of a matrix a height and widths; B4's block
#: sizes, widths, block counts and dtype pairs; B6's (B, S, d_inner, N)
WIDE_TSM = ((65, 65), (96, 96), (128, 128), (100, 72), (72, 100),
            (200, 136), (128, 16), (200, 40))
WIDE_TSM_NS = (37, 4109, 1 << 18)
WIDE_TSM_DTYPES = (torch.float64, torch.float32, torch.complex128)
WIDE_EIG_MS = (65, 96, 128)
WIDE_EIG_DEVICE_A = 200
WIDE_C = (512, 4096, None)
WIDE_B1_ROWS = {512: 4 * 512 + 5, 4096: 4 * 4096 + 5, None: 9001}
WIDE_B1_B = (1, 4, 16)
WIDE_B4_BS = (65, 128, 256)
WIDE_B4_B = (1, 4, 17)
WIDE_B4_NB = (1, 7, 300)
WIDE_B4_PAIRS = ((torch.float64, torch.float64),
                 (torch.float32, torch.float32),
                 (torch.complex128, torch.complex128),
                 (torch.complex128, torch.float64))
#: B4 past what the stream's stages hold (``block_diag_tiled``: bs past
#: 1,614 in float64, 807 in complex128, 854 for complex128 blocks on real
#: x), three blocks each: (blocks, x, bs)
WIDE_B4_TILED = ((torch.float64, torch.float64, 1700),
                 (torch.complex128, torch.complex128, 900),
                 (torch.complex128, torch.float64, 900))
WIDE_B6 = (tuple((B, S, di, N) for N in (65, 128, 256, 520)
                 for B, S, di in ((1, 257, 100), (3, 7, 8)))
           + ((65536, 3, 4, 16), (65537, 2, 3, 65)))


def _wide_tsm_cases(g, worst) -> int:
    """B2 and B3 past width 64 against their plain versions, at the TSM
    grid's bounds (real: ``_tsm_check``, Kahan to ``kahan_depth``;
    complex128: ``_cx_check``), each B2 call twice to the same bits; and
    float64 B2 at the most rows against exact sums
    (``_require_exact_kahan``)."""
    n_cases = 0
    for dt in WIDE_TSM_DTYPES:
        cx = dt.is_complex
        wide = torch.complex128 if cx else torch.float64
        name = str(dt)[6:]
        coefs = CX_TSM_COEFS if cx else TSM_COEFS
        for n in WIDE_TSM_NS:
            for m, k in WIDE_TSM:
                V, W, X, Xs = (_cx_randn(s, dt, g) for s in
                               ((n, m), (n, k), (m, k), (m, k)))
                Vd, Wd, Xd, Xsd = (t.to(wide) for t in (V, W, X, Xs))
                vw, vx = Vd.abs().T @ Wd.abs(), Vd.abs() @ Xsd.abs()
                d2 = summation_depth(n, m, k, dt)
                for alpha, beta, out in coefs:
                    tag = f"{name} n={n} m={m} k={k} alpha={alpha}"
                    want = tsmttsm_ref(Vd, Wd, Xd if out else None, alpha,
                                       beta)
                    scale = abs(alpha) * vw + abs(beta) * Xd.abs()
                    for kahan in (False, True):
                        got = tsmttsm(V, W, X if out else None, alpha, beta,
                                      kahan=kahan)
                        require(torch.equal(got, tsmttsm(
                            V, W, X if out else None, alpha, beta,
                            kahan=kahan)), f"wide B2 {tag}: two runs differ")
                        key = ("B2" + (" kahan" if kahan else ""), name)
                        w = worst.setdefault(key, [0.0, "", 0.0])
                        t = tag + f" kahan={kahan}"
                        if cx:
                            depth = (kahan_depth(n, m, k, CX_REAL[dt], dt)
                                     if kahan else d2)
                            _cx_check(got, want, scale, dt, depth, n, t, w)
                        else:
                            depth = kahan_depth(n, m, k, dt) if kahan else d2
                            _tsm_check(got, want, scale, dt, depth, n, t, w)
                    want = tsmm_ref(Vd, Xsd, Wd if out else None, alpha, beta)
                    scale = abs(alpha) * vx + abs(beta) * Wd.abs()
                    got = tsmm(V, Xs, W if out else None, alpha, beta)
                    w = worst.setdefault(("B3" + (" W" if out else ""), name),
                                         [0.0, "", 0.0])
                    if cx:
                        _cx_check(got, want, scale, dt, m, m, tag, w)
                    else:
                        _tsm_check(got, want, scale, dt, m, m, tag, w)
                    n_cases += 3
                if dt == torch.float64 and n == WIDE_TSM_NS[-1]:
                    print(f"[wide grid] B2 float64 n={n} m={m} k={k}: "
                          + _require_exact_kahan(
                              V, W, tsmttsm(V, W, kahan=True), tsmttsm(V, W),
                              g, f"wide B2 n={n} m={m} k={k}"))
            if dt == torch.float64:
                n_cases += _self_gram_cases(n, g, worst)
    return n_cases


#: (m = k) of B2's self-Gram cases (V is W) past width 64
WIDE_SELF_GRAM = (65, 128, 200)


def _self_gram_cases(n, g, worst) -> int:
    """B2's self-Gram (V the same tensor as W: the DMMA instance computes
    the 64 x 64 tiles on and above the diagonal and mirrors the rest) in
    float64 against the plain version, Kahan on and off, at the grid's
    bounds, symmetric to the bit, and a copy of V within the same bound;
    at the most rows, against exact sums (``_require_exact_kahan``)."""
    n_cases = 0
    for m in WIDE_SELF_GRAM:
        W = torch.randn(n, m, generator=g, dtype=torch.float64, device=DEVICE)
        want = tsmttsm_ref(W, W)
        scale = W.abs().T @ W.abs()
        for kahan in (False, True):
            tag = f"self-Gram n={n} m={m} kahan={kahan}"
            depth = (kahan_depth(n, m, m, torch.float64) if kahan
                     else summation_depth(n, m, m, torch.float64))
            w = worst.setdefault(("B2 self" + (" kahan" if kahan else ""),
                                  "float64"), [0.0, "", 0.0])
            for V in (W, W.clone()):
                got = tsmttsm(V, W, kahan=kahan)
                _tsm_check(got, want, scale, torch.float64, depth, n, tag, w)
            got = tsmttsm(W, W, kahan=kahan)
            require(torch.equal(got, got.T),
                    f"wide B2 {tag}: not symmetric to the bit")
            n_cases += 1
        if n == WIDE_TSM_NS[-1]:
            print(f"[wide grid] B2 self-Gram n={n} m={m}: "
                  + _require_exact_kahan(
                      W, W, tsmttsm(W, W, kahan=True), tsmttsm(W, W), g,
                      f"wide B2 self-Gram n={n} m={m}"))
    return n_cases


def _wide_b1_cases(rng, g, worst) -> int:
    """B1 on chunks past 256 rows (spread over several blocks), every
    fusion flag, real (B1 grid's tolerances) and complex128 (as float64),
    the dots twice to the same bits."""
    n_cases = 0
    for ct in (torch.float64, torch.float32, torch.complex128):
        np_ct = {torch.float64: np.float64, torch.float32: np.float32,
                 torch.complex128: np.complex128}[ct]
        tol = TOL[CX_REAL.get(ct, ct)]
        for C in WIDE_C:
            n = WIDE_B1_ROWS[C]
            rows, cols, vals = _grid_coo(n, n, rng)
            if ct.is_complex:
                vals = vals + 1j * rng.standard_normal(vals.size)
            height = n if C is None else C
            A = from_coo(rows, cols, vals, (n, n), C=height,
                         sigma=1 if C is None else C, dtype=np_ct,
                         device=DEVICE)
            cases = _cx_flag_cases if ct.is_complex else _flag_cases
            for b in WIDE_B1_B:
                x, y, z = (_cx_randn((A.nrows_pad, b), ct, g)
                           for _ in range(3))
                for name, opts, with_y, with_z in cases(b, rng, np_ct):
                    args = (A, x, y if with_y else None,
                            z if with_z else None, opts)
                    tag = (f"{str(ct)[6:]} C={'nrows' if C is None else C} "
                           f"b={b} {name}")
                    _compare(*args, tol, tag,
                             worst.setdefault(("B1", str(ct)[6:]),
                                              [0.0, ""]))
                    if name == "dots":
                        one, two = sellcs_spmv(*args), sellcs_spmv(*args)
                        require(torch.equal(one[2], two[2]),
                                f"wide B1 {tag}: two runs' dots differ")
                    n_cases += 1
    return n_cases


def _wide_b4_cases(g, worst) -> int:
    """B4 past bs = 64 (the stream, and past its stages the tiled kernel):
    real pairs at the B4 grid's bound (``_b4_check``), complex blocks at
    the complex grid's (``_cx_check`` with depth bs)."""
    n_cases = 0
    shapes = ([(bd, xd, bs, nb) for bd, xd in WIDE_B4_PAIRS
               for bs in WIDE_B4_BS for nb in WIDE_B4_NB]
              + [(bd, xd, bs, 3) for bd, xd, bs in WIDE_B4_TILED])
    for bd, xd, bs, nb in shapes:
        key = f"B4 {str(bd)[6:]} x {str(xd)[6:]}"
        w = worst.setdefault((key, ""), [0.0, "", 0.0])
        blocks = _cx_randn((nb, bs, bs), bd, g)
        for b in WIDE_B4_B:
            x = _cx_randn((nb * bs, b), xd, g)
            tag = f"{key} bs={bs} nb={nb} b={b}"
            if bd.is_complex:
                c = torch.complex128
                want = block_diag_matmul_ref(blocks.to(c), x.to(c))
                scale = block_diag_matmul_ref(blocks.to(c).abs(),
                                              x.to(c).abs())
                _cx_check(block_jacobi_apply(blocks, x), want, scale,
                          bd, bs, bs, tag, w)
            else:
                _b4_check(blocks, x, tag, w)
            n_cases += 1
    return n_cases


def phase_wide_grid() -> None:
    """Every widened instance against its plain version on the card, at
    the tolerances of the grid it joins: B2/B3 past width 64, the
    eigensolver past m = 64, B1 past C = 256 (ELLPACK included), B4 past
    bs = 64, B6 past N = 64 and B = 65535."""
    rng = np.random.default_rng(19)
    g = torch.Generator(device=DEVICE).manual_seed(19)
    worst = {}
    t0 = time.perf_counter()
    n_tsm = _wide_tsm_cases(g, worst)
    n_b1 = _wide_b1_cases(rng, g, worst)
    n_b4 = _wide_b4_cases(g, worst)
    eig_worst, n_eig = {}, 0
    for dt in EIG_DTYPES:
        w = eig_worst.setdefault(str(dt)[6:], [0.0, ""])
        for m in WIDE_EIG_MS:
            for kind in EIG_KINDS:
                _eig_check(_eig_matrix(kind, m, dt, g),
                           f"{str(dt)[6:]} m={m} {kind}", w)
                n_eig += 1
    m = WIDE_EIG_DEVICE_A
    _eig_check(_eig_matrix("gram", m, torch.float64, g),
               f"float64 m={m} gram (A in device memory)",
               eig_worst["float64"])
    n_eig += 1
    b6_worst = {}
    for i, (B, S, di, N) in enumerate(WIDE_B6):
        _b6_check(_b6_inputs(B, S, di, N, seed=1900 + i),
                  f"B={B} S={S} di={di} N={N}", b6_worst)
    sync()
    for (kern, dt), v in sorted(worst.items()):
        ratio, tag = v[0], v[1]
        print(f"[wide grid] {kern:9s} {dt:10s} worst {ratio:.3e} "
              f"{'rel err' if kern == 'B1' else 'of its bound'}  (at {tag})")
    for key, (ratio, tag) in eig_worst.items():
        print(f"[wide grid] herm_eig {key:10s} worst {ratio:.3f} of its "
              f"bounds  (at {tag})")
    for N, (r, tag) in sorted(b6_worst.items()):
        print(f"[wide grid] B6 N={N}: worst {r:.3f} of its bound ({tag})")
    print(f"[wide grid] {n_tsm} B2/B3 cases (n in {WIDE_TSM_NS}, (m, k) in "
          f"{WIDE_TSM}, {[str(d)[6:] for d in WIDE_TSM_DTYPES]}, Kahan on "
          f"and off; B2's float64 self-Gram at m in {WIDE_SELF_GRAM}), "
          f"{n_b1} B1 cases (C in 512, 4096 and nrows, b in "
          f"{WIDE_B1_B}, every flag; float64, float32, complex128), {n_b4} "
          f"B4 cases (bs in {WIDE_B4_BS}; past the stream "
          f"{[(str(a)[6:], str(b)[6:], bs) for a, b, bs in WIDE_B4_TILED]}), {n_eig} eigensolver cases (m in "
          f"{WIDE_EIG_MS}, four dtypes; m = {WIDE_EIG_DEVICE_A} float64), "
          f"{len(WIDE_B6)} B6 cases ({WIDE_B6}) within the bounds of the "
          f"grids they join, in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 12c
#: the width of the block-CG path that the widened instances open, its
#: tolerance, and the iterations of its profiled and sync-counted windows
WIDE_WIDTH = 128
WIDE_TOL = 1e-8
WIDE_MAXITER = 3000
WIDE_PROFILED = 3


def phase_block_cg_wide(fw, card):
    """Block CG at width 128 on laplace3d(NX) in float64: B1 at b = 128
    (8 column slices), B2 and B3 at 128 x 128 and the eigensolver at m =
    128, every column held to its true residual; the launches, host syncs
    in late-read iterations and the device time by kind of kernel."""
    A = fw["A64"]
    op = make_operator(A)
    g = torch.Generator(device=DEVICE).manual_seed(128)
    b = A.permute(torch.randn(A.nrows, WIDE_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    execution.reset_launch_counts()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=WIDE_TOL, maxiter=WIDE_MAXITER, block=True)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts()
    it = res.iters
    d = dropped("block_cg")
    # the plain SpMV gathers a value a slot and column: WIDTH columns at a
    # time, not 128 (29 GB of gathered products)
    relres = torch.cat([_colwise_relres(A, b[:, j:j + WIDTH].contiguous(),
                                        res.x[:, j:j + WIDTH].contiguous())
                        for j in range(0, WIDE_WIDTH, WIDTH)])
    ms_iter = 1e3 * secs / max(it, 1)
    print(f"[block cg {WIDE_WIDTH}] laplace3d({NX}) f64 width {WIDE_WIDTH} "
          f"tol {WIDE_TOL}: {it} iterations in {secs:.3f} s ({ms_iter:.3f} "
          f"ms/iter), converged={bool(res.converged.all())}, true relative "
          f"residual max {float(relres.max()):.2e} min "
          f"{float(relres.min()):.2e}; peak memory {_peak_gb():.1f} GB  "
          f"[{card}]")
    print(f"[block cg {WIDE_WIDTH}] launches {launches} (per iteration: 1 "
          f"sellcs_spmv, 2 tsmttsm, 4 tsmm, 2 herm_eig; init: 1 each; {d} "
          f"discarded iteration)")
    require(bool(res.converged.all()), f"block CG {WIDE_WIDTH}: not converged")
    require(float(relres.max()) <= 10 * WIDE_TOL,
            f"block CG {WIDE_WIDTH}: true residual {float(relres.max())} > "
            f"{10 * WIDE_TOL}")
    n_it = it + d
    want = {"sellcs_spmv": n_it + 1, "tsmttsm": 2 * n_it + 1,
            "tsmm": 4 * n_it + 1, "herm_eig": 2 * n_it + 1}
    require(launches == want or DEVICE == "cpu",
            f"block CG {WIDE_WIDTH} launches {launches} != {want}")
    del res
    st0 = cg_init(op, b, tol=WIDE_TOL, maxiter=WIDE_MAXITER, block=True)
    split = None
    if DEVICE == "cuda":
        syncs = _syncs(lambda: run_chunk(op, "block_cg", 3, st0,
                                         block.block_cg_body))
        print(f"[block cg {WIDE_WIDTH}] synchronising calls in 3 late-read "
              f"iterations: {syncs}")
        require(syncs == 0, f"block CG {WIDE_WIDTH}: {syncs} synchronising "
                f"calls in 3 late-read iterations")
        split = _device_split(lambda: run_chunk(
            op, "block_cg", WIDE_PROFILED, st0, block.block_cg_body),
            WIDE_PROFILED)
    if split is None:
        print(f"[block cg {WIDE_WIDTH}] device split not measured")
    else:
        parts = ", ".join(f"{kind} {ms:.3f}" for kind, ms in
                          sorted(split["kinds"].items()))
        print(f"[block cg {WIDE_WIDTH}] {WIDE_PROFILED} late-read iterations "
              f"under the profiler: {split['wall']:.3f} ms/iter wall; device "
              f"ms/iter: {parts}; card idle {split['idle']:.3f} ms/iter "
              f"({100 * split['idle_share']:.1f}% of the window)  [{card}]")
    st = run_chunk(op, "block_cg", 1, st0, block.block_cg_body)
    return dict(iters=it, secs=secs, ms_iter=ms_iter, launches=launches,
                state=st, op=op, split=split)


# ---------------------------------------------------------------- phase 12d
#: FP64 through the tensor cores (DMMA), the H100 SXM's FP64 peak (NVIDIA
#: data sheet): the operations bound of the wide B2/B3 rows (the CUDA
#: cores' 34 TFLOP/s of PEAK_FLOPS printed beside it)
DMMA_FLOPS_F64 = 67e12
#: B1's chunk heights timed against C = 32 on laplace3d(NX) (None: C =
#: nrows), the width, and the column-CG path on the tallest-but-one
WIDE_B1_TIMED = (1024, None)
WIDE_SPMV_B = 4
#: B4 at bs = 128: rows and width; the block-Jacobi PCG path on
#: anisotropic_laplace2d(WIDE_PCG_NX) with blocks of WIDE_B4_TIMED_BS
WIDE_B4_TIMED_BS, WIDE_B4_ROWS = 128, 4_194_304
WIDE_PCG_NX = 512
#: B6 at N = 128: (B, S, d_inner); the error is checked on the first
#: WIDE_B6_CHECK_S timesteps (the scan is causal, so they are the whole
#: run's), and the Mamba mixer path at jamba's d_model with this N
WIDE_B6_SHAPE, WIDE_B6_N, WIDE_B6_CHECK_S = (4, 4096, 16384), 128, 256


def _wide_tsm_rows(n, card, rows):
    """B2 (Kahan, its self-Gram W^T W, and plain) and B3 (with and without
    W) at n x 128 in float64: kernel, plain version, `addmm`/`mm`, and the
    bound at DMMA's FP64 rate (a self-Gram reads W once and needs the
    products on and above the diagonal); the Kahan sums also against exact
    sums (``_require_exact_kahan``)."""
    m = WIDE_WIDTH
    f64 = torch.float64
    g = torch.Generator(device=DEVICE).manual_seed(12)
    V, W = (torch.randn(n, m, generator=g, dtype=f64, device=DEVICE)
            for _ in range(2))
    X = torch.randn(m, m, generator=g, dtype=f64, device=DEVICE)
    flops = 2.0 * n * m * m
    vw = V.abs().T @ W.abs()
    cases = [
        ("tsmttsm", "kahan", lambda: tsmttsm(V, W, kahan=True),
         lambda: tsmttsm_ref(V, W, kahan=True),
         lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0),
         (V, W), kahan_depth(n, m, m, f64)),
        ("tsmttsm", "self-Gram kahan", lambda: tsmttsm(W, W, kahan=True),
         lambda: tsmttsm_ref(W, W, kahan=True),
         lambda: torch.addmm(X, W.mT, W, beta=0.0, alpha=1.0),
         (W,), kahan_depth(n, m, m, f64)),
        ("tsmttsm", "plain sum", lambda: tsmttsm(V, W),
         lambda: tsmttsm_ref(V, W),
         lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0),
         (V, W), summation_depth(n, m, m, f64)),
        ("tsmm", "with W", lambda: tsmm(V, X, W, 1.0, 1.0),
         lambda: tsmm_ref(V, X, W, 1.0, 1.0),
         lambda: torch.addmm(W, V, X, beta=1.0, alpha=1.0), (V, X, W), m),
        ("tsmm", "without W", lambda: tsmm(V, X), lambda: tsmm_ref(V, X),
         lambda: torch.mm(V, X), (V, X), m),
    ]
    ww = W.abs().T @ W.abs()
    for name, variant, kern, plain, lib, inputs, depth in cases:
        got = kern()
        if variant == "self-Gram kahan":
            want, scale = tsmttsm_ref(W, W), ww
            require(torch.equal(got, got.T), "wide B2 self-Gram: not "
                    "symmetric to the bit")
            print(f"[wide timing] tsmttsm {variant} f64 n={n} m=k={m}: "
                  + _require_exact_kahan(W, W, got, tsmttsm(W, W), g,
                                         f"wide B2 {variant} n={n}"))
        elif variant == "kahan":
            want, scale = tsmttsm_ref(V, W), vw
            print(f"[wide timing] tsmttsm {variant} f64 n={n} m=k={m}: "
                  + _require_exact_kahan(V, W, got, tsmttsm(V, W), g,
                                         f"wide B2 {variant} n={n}"))
        elif name == "tsmttsm":
            want, scale = tsmttsm_ref(V, W), vw
        else:
            want = plain()
            scale = V.abs() @ X.abs() + (W.abs() if variant == "with W"
                                         else 0.0)
        err = float(_tsm_check(got, want, scale, f64, depth, n,
                               f"wide {name} {variant} n={n}").max())
        del want, scale
        ms = time_ms(kern, warmup=3, iters=20)
        slow = "kahan" in variant            # a Python loop over blocks
        plain_ms = time_ms(plain, warmup=1 if slow else 3,
                           iters=1 if slow else 10)
        lib_ms = time_ms(lib, warmup=3, iters=20)
        nbytes = _nbytes(*inputs, got)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        # a self-Gram needs the products on and above the diagonal
        ops = flops * (m + 1) / (2 * m) if len(inputs) == 1 else flops
        ops_ms = 1e3 * ops / DMMA_FLOPS_F64
        core_ms = 1e3 * flops / PEAK_FLOPS[f64]
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[wide timing] {name} {variant} f64 n={n} m=k={m}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms for "
              f"{nbytes / 1e9:.3f} GB; {ops / 1e9:.1f} GFLOP {ops_ms:.4f} "
              f"ms at DMMA's 67 TFLOP/s, {core_ms:.4f} ms at the CUDA cores' "
              f"34), {100 * bound_ms / ms:.1f}% of bound, "
              f"{100 * core_ms / ms:.1f}% of the CUDA cores' rate, max abs "
              f"err {err:.3e}  [{card}]")
        rows[(name, variant)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", err=err)


def eig_bound(m):
    """``(bound_ms, bound_by, ops_ms, bytes_ms)`` of a real symmetric
    eigendecomposition with vectors at order m, from the function alone
    and so the same whatever the design: about 9 m^3 flops (the symmetric
    QR algorithm's count with vectors, Golub and Van Loan 8.3) at DMMA's
    FP64 rate, and its bytes (A read, U and the eigenvalues written:
    2 m^2 + m values)."""
    ops_ms = 1e3 * 9.0 * m ** 3 / DMMA_FLOPS_F64
    bytes_ms = 1e3 * (2 * m * m + m) * 8 / HBM_BYTES_PER_S
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def _wide_eig_row(bcg, card):
    """The eigensolver at m = 128 on the width-128 block CG's Gram of its
    search block against `torch.linalg.eigh` (with its host sync)."""
    m = WIDE_WIDTH
    P = bcg["state"].p
    Gs = block._herm(tsmttsm(P, bcg["op"].mv(P), kahan=True))
    worst = [0.0, ""]
    _eig_check(Gs, f"block CG Gram m={m}", worst)
    err = float((herm_eig(Gs)[0] - torch.linalg.eigvalsh(Gs)).abs().max())
    ms = time_ms(lambda: herm_eig(Gs), warmup=3, iters=20)
    eigh_ms = time_ms(lambda: torch.linalg.eigh(Gs), warmup=3, iters=20)
    sweeps = int(herm_eig_cuda(Gs)[2]) if DEVICE == "cuda" else 0
    # block Jacobi's sweeps are wide_order(m) / BLOCK - 1 rounds, each a
    # pair's 2 BLOCK - 1 inner rounds on one warp
    rounds = sweeps * (wide_order(m) // EIG_BLOCK - 1)
    bound_ms, by, ops_ms, bytes_ms = eig_bound(m)
    per_round = 1e3 * ms / rounds if rounds else float("nan")
    print(f"[wide timing] herm_eig f64 m={m} (a block-CG Gram): kernel "
          f"{ms:.4f} ms, torch.linalg.eigh {eigh_ms:.4f} ms (with its host "
          f"sync), bound {bound_ms:.6f} ms (operations {ops_ms:.6f} for "
          f"9 m^3 flops at DMMA's 67 TFLOP/s, bytes {bytes_ms:.6f}), "
          f"{100 * bound_ms / ms:.1f}% of bound; latency: {sweeps} sweeps of "
          f"block Jacobi, a chain of {rounds} rounds ({per_round:.2f} us a "
          f"round, {(2 * EIG_BLOCK - 1) * rounds} dependent inner rounds a "
          f"warp); within {worst[0]:.3f} of its bounds against eigh  "
          f"[{card}]")
    return dict(ms=ms, plain_ms=eigh_ms, library_ms=eigh_ms,
                bound_ms=bound_ms, bound_by=by, err=err)


def _wide_b1_row(fw, card):
    """B1 at b = 4 on laplace3d(NX) stored with tall chunks (C = 1024 and
    C = nrows) against C = 32, each held against its plain version; the
    launch grid; and column CG on the C = 1024 matrix, B1's wide path."""
    r, c, v, n = fw["coo"]
    g = torch.Generator(device=DEVICE).manual_seed(41)
    opts = SpmvOpts(dot_xy=True)              # what column CG asks of it
    out = {}
    for C in (32,) + WIDE_B1_TIMED:
        height = n if C is None else C
        label = "nrows" if C is None else str(C)
        if C == 32:
            A = fw["A64"]
        else:
            t0 = time.perf_counter()
            A = from_coo(r, c, v, (n, n), C=height,
                         sigma=1 if C is None else height, dtype=np.float64,
                         device=DEVICE)
            sync()
            print(f"[wide timing] laplace3d({NX}) at C={label}: host build "
                  f"{time.perf_counter() - t0:.1f} s, {A.nchunks} chunks")
        x = torch.randn(A.nrows_pad, WIDE_SPMV_B, generator=g,
                        dtype=torch.float64, device=DEVICE)
        yk, _, dk = sellcs_spmv(A, x, opts=opts)
        yr, _, dr = sellcs_spmv_ref(A, x, opts=opts)
        err = float((yk - yr).abs().max())
        e_rel, d_rel = rel_err(yk, yr), rel_err(dk, dr)
        require(e_rel <= TOL[torch.float64]["vec"]
                and d_rel <= TOL[torch.float64]["dots"],
                f"wide B1 C={label}: rel err {e_rel:.3e}, dots {d_rel:.3e}")
        ms = time_ms(lambda: sellcs_spmv(A, x, opts=opts))
        plain_ms = time_ms(lambda: sellcs_spmv_ref(A, x, opts=opts),
                           warmup=2, iters=5)
        lib_ms = None
        if C == WIDE_B1_TIMED[0]:             # the kernels line's row
            csr = _library_csr(A, fw["coo"])
            require(rel_err(csr @ x, yk) <= 1e-12,
                    f"wide B1 C={label}: the library product disagrees")
            lib_ms = time_ms(lambda: csr @ x)
            del csr
        geo = launch_geometry(WIDE_SPMV_B, height, A.dtype, dots=True)
        parts = chunk_parts(height, geo)
        grid = dot_parts(A.nchunks, parts)
        nbytes = _spmv_bytes(A, x, yk, dk)
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        print(f"[wide timing] sellcs_spmv f64 b={WIDE_SPMV_B} <p, Ap> C="
              f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library(csr@x) "
              f"{'not timed' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of bound; grid "
              f"{grid} x {geo.slices} blocks of {geo.threads} threads "
              f"({A.nchunks} chunks of {height} rows, {parts} blocks a chunk,"
              f" {geo.tpr} threads a row); max abs err {err:.3e}  [{card}]")
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by="bytes", err=err, A=A)
    # the path through the tall chunks: column CG on the C = 1024 matrix
    A = out[str(WIDE_B1_TIMED[0])]["A"]
    b = A.permute(torch.from_numpy(fw["b_host"]).to(DEVICE))
    execution.reset_launch_counts()
    res = cg(make_operator(A), b, tol=1e-8, maxiter=3000)
    launches = execution.launch_counts().get(KERNEL, 0)
    relres = _colwise_relres(A, b, res.x)
    print(f"[wide timing] column CG f64 b=4 on C={WIDE_B1_TIMED[0]}: "
          f"{res.iters} iterations (C=32: {fw['iters64']}), {launches} B1 "
          f"launches, true relative residual max {float(relres.max()):.2e}")
    require(bool(res.converged.all()) and float(relres.max()) <= 1e-7,
            f"column CG on C={WIDE_B1_TIMED[0]}: not converged")
    row = {k: v for k, v in out[str(WIDE_B1_TIMED[0])].items() if k != "A"}
    row["nrows"] = {k: v for k, v in out["nrows"].items() if k != "A"}
    return row, launches


def _wide_b4_row(card):
    """B4 at bs = 128 on 4,194,304 rows, b = 4, float64 (4.29 GB of
    blocks): kernel, plain version, `bmm`, bound; then block-Jacobi PCG
    with blocks of 128, B4's wide path."""
    bs, rows = WIDE_B4_TIMED_BS, WIDE_B4_ROWS
    g = torch.Generator(device=DEVICE).manual_seed(44)
    blocks = torch.randn(rows // bs, bs, bs, generator=g,
                         dtype=torch.float64, device=DEVICE)
    x = torch.randn(rows, 4, generator=g, dtype=torch.float64, device=DEVICE)
    worst = [0.0, "", 0.0]
    err = _b4_check(blocks, x, f"wide timing bs={bs}", worst)
    kern = lambda: block_jacobi_apply(blocks, x)
    lib = lambda: torch.bmm(blocks, x.view(-1, bs, 4))
    ms = time_ms(kern, warmup=3, iters=20)
    plain_ms = time_ms(lambda: block_diag_matmul_ref(blocks, x), warmup=2,
                       iters=5)
    lib_ms = time_ms(lib, warmup=3, iters=20)
    nbytes = _nbytes(blocks, x, x)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[wide timing] block_diag_matmul f64 bs={bs} rows={rows} b=4: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (bmm) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB),"
          f" {100 * bound_ms / ms:.1f}% of bound, max abs err {err:.3e}  "
          f"[{card}]")
    del blocks, x
    A = _aniso(WIDE_PCG_NX)
    t0 = time.perf_counter()
    M = make_preconditioner(f"block_jacobi:{bs}", matrix=A)
    setup = time.perf_counter() - t0
    b = A.permute(torch.randn(A.nrows, 4, generator=g, dtype=torch.float64,
                              device=DEVICE))
    execution.reset_launch_counts()
    res = cg(make_operator(A), b, tol=PCG_TOL, maxiter=8 * A.nrows, M=M)
    launches = execution.launch_counts().get("block_diag_matmul", 0)
    relres = _colwise_relres(A, b, res.x)
    print(f"[wide timing] block-Jacobi PCG bs={bs} on anisotropic_laplace2d"
          f"({WIDE_PCG_NX}) f64 b=4: set-up {setup:.1f} s, {res.iters} "
          f"iterations, {launches} B4 launches, true relative residual max "
          f"{float(relres.max()):.2e}")
    require(bool(res.converged.all())
            and float(relres.max()) <= 10 * PCG_TOL,
            f"PCG bs={bs}: not converged")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by="bytes", err=err), launches


def _wide_b6_row(card):
    """B6 at N = 128, B 4 x S 4096 x d_inner 16384: kernel, plain version
    once, the bound (bytes, and the exponentials at MUFU's rate); the
    error on the first WIDE_B6_CHECK_S timesteps; then a Mamba mixer of
    jamba's d_model with this state size, B6's wide path."""
    B, S, di = WIDE_B6_SHAPE
    N = WIDE_B6_N
    args = list(_b6_inputs(B, S, di, N, seed=61))
    args[0] = args[0].clamp(max=1.0)          # dt as a model has it
    y = mamba_scan(*args)
    head = [a[:, :WIDE_B6_CHECK_S] if a.ndim == 3 else a for a in args]
    want = mamba_scan_ref(*(t.double() for t in head))
    diff = (y[:, :WIDE_B6_CHECK_S].double() - want).abs()
    ratio = float((diff / scan_error_bound(*head)).max())
    err = float(diff.max())
    del want, diff, head
    require(ratio <= 1.0, f"wide B6 N={N}: error {ratio:.3f} of its bound")
    ms = time_ms(lambda: mamba_scan(*args), warmup=2, iters=10)
    sync()
    t0 = time.perf_counter()
    mamba_scan_ref(*args)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = _nbytes(*args, y)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    props = torch.cuda.get_device_properties(0)
    clock = _sm_clock_hz()
    nexp = B * S * di * N
    exp_ms = 1e3 * nexp / (SFU_EXP_PER_CLK * props.multi_processor_count
                           * clock)
    bound_ms = max(bytes_ms, exp_ms)
    print(f"[wide timing] mamba_scan f32 B={B} S={S} di={di} N={N}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms (once), library n/a, bound "
          f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms; {nexp / 1e9:.2f} G "
          f"exponentials {exp_ms:.4f} ms at {SFU_EXP_PER_CLK}/clock/SM x "
          f"{props.multi_processor_count} SMs x {clock / 1e9:.2f} GHz), "
          f"{100 * bound_ms / ms:.1f}% of bound, max abs err {err:.3e} on "
          f"the first {WIDE_B6_CHECK_S} steps ({ratio:.3f} of its bound)  "
          f"[{card}]")
    del args, y
    # the path: a Mamba mixer (in_proj, conv, x_proj, the scan, out_proj)
    # at jamba's d_model with 128 states, bf16 weights from a seed
    cfg = SSM.SSMConfig(d_state=N, scan_impl="kernel")
    d_model = di // cfg.expand
    gen = torch.Generator(device=DEVICE).manual_seed(62)
    p = SSM.mamba_init(gen, d_model, cfg)
    xin = torch.randn(B, S, d_model, generator=gen, device=DEVICE,
                      dtype=torch.float32).to(torch.bfloat16)
    execution.reset_launch_counts()
    with torch.no_grad():
        out = SSM.mamba_apply(p, xin, cfg)
    sync()
    launches = execution.launch_counts().get("mamba_scan", 0)
    require(bool(torch.isfinite(out.float()).all())
            and (launches == 1 or DEVICE == "cpu"),
            f"Mamba mixer N={N}: finite {bool(torch.isfinite(out.float()).all())}"
            f", {launches} B6 launches")
    print(f"[wide timing] Mamba mixer d_model={d_model} N={N} B={B} S={S} "
          f"bf16: output {tuple(out.shape)} finite, {launches} B6 launch")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= exp_ms else "operations",
                err=err), launches


def phase_wide_timing(fw, bcg, card):
    """The widened instances at full size beside their bounds, plain
    versions and library calls, and the paths that run the ones no solver
    of the main path reaches (B1's tall chunks, B4 at bs = 128, B6 at N =
    128)."""
    rows, launches = {}, {}
    _wide_tsm_rows(fw["A64"].nrows_pad, card, rows)
    gc.collect()
    torch.cuda.empty_cache()
    rows["herm_eig"] = _wide_eig_row(bcg, card)
    rows["sellcs_spmv"], launches["sellcs_spmv"] = _wide_b1_row(fw, card)
    gc.collect()
    torch.cuda.empty_cache()
    rows["block_diag_matmul"], launches["block_diag_matmul"] = _wide_b4_row(
        card)
    gc.collect()
    torch.cuda.empty_cache()
    rows["mamba_scan"], launches["mamba_scan"] = _wide_b6_row(card)
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------- phase 13c
def _cx_relres(A, b, x) -> torch.Tensor:
    """True relative residual per column, through the plain SpMV in
    complex128."""
    A128 = A if A.dtype == torch.complex128 else dataclasses.replace(
        A, vals=A.vals.to(torch.complex128))
    b, x = b.to(torch.complex128), x.to(torch.complex128)
    Ax, _, _ = sellcs_spmv_ref(A128, x)
    return (b - Ax).norm(dim=0) / b.norm(dim=0)


def _cx_solve(label, run, A, b, tol, real_iters, kernels, want_of, name,
              card, relres=None, tally=None):
    """Run one complex solve, timed (after an untimed run that loads the
    complex kernels), and hold it to the gates: converged, every column's
    true relative residual at most 10 tol, and each kernel's launches as
    the recurrence says (``want_of(iterations + discarded)``); the
    launches are added to ``tally``."""
    run()
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = run()
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(kernels)
    d = dropped(name)
    rel = (relres or _cx_relres)(A, b, res.x)
    it = int(res.iters)
    print(f"[complex solves] {label}: {it} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(it, 1):.3f} ms/iter; the real matrix "
          f"{real_iters}), converged={bool(res.converged.all())}, true rel "
          f"residuals {' '.join(f'{e:.2e}' for e in rel.tolist())} (tol "
          f"{tol}), launches {launches} ({d} discarded iteration)  [{card}]")
    require(bool(res.converged.all()), f"complex {label}: not converged")
    require(float(rel.max()) <= 10 * tol,
            f"complex {label}: true residual {float(rel.max())} > {10 * tol}")
    require(d <= 1, f"complex {label}: {d} discarded iterations")
    want = want_of(it + d)
    require(launches == want or DEVICE == "cpu",
            f"complex {label}: launches {launches} != {want}")
    for kname, count in launches.items():
        if tally is not None:
            tally[kname] = tally.get(kname, 0) + count
    return dict(iters=it, secs=secs, ms=1e3 * secs / max(it, 1), res=res)


def phase_complex_solves(fw, bcg, bminres_iters, card):
    """Complex Hermitian solves on the phased matrices through the normal
    entry points, each on the kernels: column CG in complex128 and
    complex64, block CG and block MINRES, Lanczos against an ``impl="ref"``
    operator, block-Jacobi PCG and PMINRES, and the engine's matvec and
    CG through ``DistOperator``."""
    r, c, v, n = fw["coo"]
    t0 = time.perf_counter()
    hv = phased(r, c, v, n, CX_SEED)
    t_phase = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = from_coo(r, c, hv, (n, n), C=32, sigma=1024, dtype=np.complex128,
                 device=DEVICE)
    sync()
    print(f"[complex solves] phased laplace3d({NX}) n={n} nnz={A.nnz} "
          f"C=32 sigma=1024 complex128: phases {t_phase:.1f} s, build "
          f"{time.perf_counter() - t0:.1f} s")
    # the same matrix rounded to complex64 (from_coo would give the same
    # arrays: the layout depends on the row lengths alone)
    A64 = dataclasses.replace(A, vals=A.vals.to(torch.complex64))
    g = torch.Generator(device=DEVICE).manual_seed(CX_SEED)
    b = A.permute(_cx_randn((n, 4), torch.complex128, g))
    tally = {}   # the complex128 solves' launches, for the kernels line
    out = {"A": A, "coo": (r, c, hv, n), "launches": tally}
    one = ("sellcs_spmv",)
    for Ak, tol in ((A, CX_TOL[torch.complex128]),
                    (A64, CX_TOL[torch.complex64])):
        op = make_operator(Ak)
        bk = b.to(Ak.dtype)
        s = _cx_solve(f"column CG {str(Ak.dtype)[6:]} b=4 tol {tol}",
                      lambda: cg(op, bk, tol=tol, maxiter=3000), Ak, bk, tol,
                      fw["iters64"], one, lambda i: {"sellcs_spmv": i + 1},
                      "cg", card,
                      tally=tally if Ak.dtype == torch.complex128 else None)
        out[f"cg {str(Ak.dtype)[6:]}"] = s
    op = make_operator(A)
    bw = A.permute(_cx_randn((n, CX_WIDTH), torch.complex128, g))
    tol = CX_TOL[torch.complex128]
    _cx_solve(f"block CG complex128 width {CX_WIDTH} tol {tol}",
              lambda: cg(op, bw, tol=tol, maxiter=3000, block=True), A, bw,
              tol, bcg["iters"], BLOCK_KERNELS,
              lambda i: {"sellcs_spmv": i + 1, "tsmttsm": 2 * i + 1,
                         "tsmm": 4 * i + 1, "herm_eig": 2 * i + 1},
              "block_cg", card, tally=tally)
    mtol = 1e-6
    _cx_solve(f"block MINRES complex128 width {CX_WIDTH} tol {mtol}",
                  lambda: minres(op, bw, tol=mtol, maxiter=3000, block=True),
                  A, bw, mtol, bminres_iters, BLOCK_KERNELS,
                  lambda i: {"sellcs_spmv": i + 1, "tsmttsm": 4 * i + 1,
                             "tsmm": 9 * i + 1, "herm_eig": i + 1},
                  "block_minres", card, tally=tally)

    # Lanczos with reorthogonalisation, against the same recurrence through
    # the plain SpMV on the card
    v0 = A.permute(_cx_randn((n,), torch.complex128, g))
    execution.reset_launch_counts()
    t0 = time.perf_counter()
    lk = lanczos(op, v0, CX_LANCZOS_K, reorth=True)
    sync()
    secs = time.perf_counter() - t0
    launches = execution.launch_counts().get(KERNEL, 0)
    lr = lanczos(make_operator(A, impl="ref"), v0, CX_LANCZOS_K, reorth=True)
    ek, _ = tridiag_eigh(lk.alphas, lk.betas)
    er, _ = tridiag_eigh(lr.alphas, lr.betas)
    dlo = abs(ek[0] - er[0]) / abs(er[0])
    dhi = abs(ek[-1] - er[-1]) / abs(er[-1])
    emin = 6.0 - 6.0 * np.cos(np.pi / (NX + 1))
    print(f"[complex solves] Lanczos k={CX_LANCZOS_K} reorth complex128: "
          f"{secs:.3f} s, extremes [{ek[0]:.12f}, {ek[-1]:.12f}], through "
          f"impl='ref' [{er[0]:.12f}, {er[-1]:.12f}] (relative {dlo:.2e}, "
          f"{dhi:.2e}); the real matrix' lambda_min {emin:.6f} is a lower "
          f"bound; B1 launches {launches}  [{card}]")
    require(max(dlo, dhi) <= CX_LANCZOS_TOL,
            f"complex Lanczos: extremes {dlo:.2e}, {dhi:.2e} off impl='ref'")
    require(launches == CX_LANCZOS_K or DEVICE == "cpu",
            f"complex Lanczos: {launches} B1 launches != {CX_LANCZOS_K}")
    out.update(_cx_eigen(A, op, v0, card))

    # pipelined CG (its dots conjugated): plain CG's count, within 2
    tol = CX_TOL[torch.complex128]
    plain_iters = out["cg complex128"]["iters"]
    s = _cx_solve(f"pipelined CG complex128 b=4 tol {tol}",
                  lambda: cg_mod.pipelined_cg(op, b, tol=tol, maxiter=3000),
                  A, b, tol, plain_iters, ("sellcs_spmv",),
                  lambda i: {"sellcs_spmv": i + 2}, "pipelined_cg", card,
                  tally=tally)
    require(s["iters"] <= plain_iters + 2,
            f"complex pipelined CG: {s['iters']} iterations > plain CG's "
            f"{plain_iters} + 2")
    # B5's complex variant on its path here: the true residual of the
    # complex CG solution, r = b - A x with <r, r> and <b, b> in one sweep
    x = out["cg complex128"]["res"].x
    execution.reset_launch_counts()
    Ax = op.mv(x)
    _, dots = fused_axpby_dots(b, Ax, 1.0, -1.0, dot_yy=True, dot_xx=True)
    relres = torch.sqrt(dots[0].real / dots[2].real)
    sync()
    b5 = execution.launch_counts().get("fused_axpby_dots", 0)
    plain = _cx_relres(A, b, x)
    diff = float(((relres - plain).abs() / plain).max())
    print(f"[complex solves] complex CG true relative residual through "
          f"fused_axpby_dots (complex128): "
          f"{' '.join(f'{v:.6e}' for v in relres.tolist())}; through the "
          f"plain SpMV: {' '.join(f'{v:.6e}' for v in plain.tolist())}; max "
          f"relative difference {diff:.2e}; fused_axpby_dots launches {b5}")
    # |r| ~ 1e-8 |b|: the two SpMVs' summation orders show at ~1e-8 of |r|
    require(diff <= 1e-4, f"complex B5 residual differs from plain by {diff}")
    require(b5 == 1 or DEVICE == "cpu",
            f"complex fused_axpby_dots launches {b5} != 1")
    out["b5 launches"] = b5

    # block-Jacobi PCG and PMINRES on the phased anisotropic Laplacian,
    # with the real matrix' solves beside them
    ra, ca, va, na = anisotropic_laplace2d(CX_PRECOND_NX, epsilon=PRECOND_EPS)
    ha = phased(ra, ca, va, na, CX_SEED + 1)
    kw = dict(C=PRECOND_C, sigma=1, device=DEVICE)
    t0 = time.perf_counter()
    P = from_coo(ra, ca, ha, (na, na), dtype=np.complex128, **kw)
    M = make_preconditioner("block_jacobi", matrix=P)
    Pr = from_coo(ra, ca, va, (na, na), dtype=np.float64, **kw)
    Mr = make_preconditioner("block_jacobi", matrix=Pr)
    sync()
    print(f"[complex solves] phased anisotropic_laplace2d({CX_PRECOND_NX}, "
          f"eps={PRECOND_EPS}) n={na} C={PRECOND_C} sigma=1, bs "
          f"{M.block_size} ({M.inv_blocks.dtype}): complex and real builds "
          f"and set-ups {time.perf_counter() - t0:.1f} s")
    pb = P.permute(_cx_randn((na, PRECOND_WIDTH), torch.complex128, g))
    pbr = pb.real.contiguous()      # sigma = 1: the same permutation
    opP, opR = make_operator(P), make_operator(Pr)
    maxiter = 8 * na
    real_pcg = cg(opR, pbr, tol=PCG_TOL, maxiter=maxiter, M=Mr)
    real_pmr = minres(opR, pbr, tol=PMINRES_TOL, maxiter=maxiter, M=Mr)
    _cx_solve(f"block-Jacobi PCG complex128 b={PRECOND_WIDTH} tol {PCG_TOL}",
              lambda: cg(opP, pb, tol=PCG_TOL, maxiter=maxiter, M=M), P, pb,
              PCG_TOL, int(real_pcg.iters), PRECOND_KERNELS,
              lambda i: {"sellcs_spmv": i + 1, "block_diag_matmul": i + 1},
              "cg_precond", card, tally=tally)
    _cx_solve(f"block-Jacobi PMINRES complex128 b={PRECOND_WIDTH} tol "
              f"{PMINRES_TOL} (M-norm)",
              lambda: minres(opP, pb, tol=PMINRES_TOL, maxiter=maxiter, M=M),
              P, pb, PMINRES_TOL, int(real_pmr.iters), PRECOND_KERNELS,
              lambda i: {"sellcs_spmv": i + 1, "block_diag_matmul": i + 2},
              "minres_precond", card,
              relres=lambda A_, b_, x_: _m_relres(M, A_, b_, x_), tally=tally)
    out["M"] = M

    # the engine: one shard a card where there are several, else
    # ENGINE_SHARDS card shards on the one card
    ncards = torch.cuda.device_count() if DEVICE == "cuda" else 1
    devs = None if ncards > 1 else [DEVICE] * ENGINE_SHARDS
    label = (f"{ncards} cards, a shard each" if devs is None
             else f"{ENGINE_SHARDS} card shards")
    t0 = time.perf_counter()
    eng = HeterogeneousEngine(r, c, hv, n, devices=devs, C=32, sigma=1024,
                              dtype=np.complex128)
    sync()
    build_s = time.perf_counter() - t0
    xo = _cx_randn((n, 4), torch.complex128, g)
    execution.reset_launch_counts()
    y_eng, _ = eng.spmv(xo)
    sync()
    got = execution.launch_counts().get(KERNEL, 0)
    y_one = A.unpermute(sellcs_spmv(A, A.permute(xo))[0])
    err = rel_err(y_eng.to(y_one.device), y_one)
    print(f"[complex solves] engine, {label}: build {build_s:.1f} s; one "
          f"complex128 matvec (b=4) {err:.2e} of max|y| off the one-device "
          f"SpMV, B1 launches {got}  [{card}]")
    require(err <= CX_ENGINE_TOL, f"complex engine matvec: {err:.2e} of "
            f"max|y| off the one-device SpMV")
    require(got == _card_launches(eng.A) or DEVICE == "cpu",
            f"complex engine matvec: {got} B1 launches != "
            f"{_card_launches(eng.A)}")
    eop = eng.operator()
    bo = A.unpermute(b)
    bop = eop.to_op_space(bo.to(eop.device))
    tol = CX_TOL[torch.complex128]
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(eop, bop, tol=tol, maxiter=3000)
    sync()
    secs = time.perf_counter() - t0
    got = execution.launch_counts().get(KERNEL, 0)
    d = dropped("cg")
    x_eng = eop.from_op_space(res.x).to(A.device)
    rel = _cx_relres(A, b, A.permute(x_eng))
    print(f"[complex solves] engine CG through DistOperator, {label}, b=4 "
          f"tol {tol}: {res.iters} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(res.iters, 1):.3f} ms/iter; one device "
          f"{out['cg complex128']['iters']} at "
          f"{out['cg complex128']['ms']:.3f} ms/iter), true rel residuals "
          f"{' '.join(f'{e:.2e}' for e in rel.tolist())}, B1 launches {got} "
          f"({d} discarded iteration)  [{card}]")
    require(bool(res.converged.all()), "complex engine CG: not converged")
    require(float(rel.max()) <= 10 * tol,
            f"complex engine CG: true residual {float(rel.max())}")
    want = (res.iters + d + 1) * _card_launches(eng.A)
    require(got == want or DEVICE == "cpu",
            f"complex engine CG: {got} B1 launches != {want}")
    del eng, eop
    return out


def _cx_eigen(A, op, v0, card):
    """ChebFD and KPM on the phased matrix in complex128: ChebFD's
    lowest Ritz value against lambda_min from a Lanczos run of
    CX_REF_LANCZOS_K steps, and KPM's mu_2, fused and unfused, against
    2 ||A_s v||^2 - ||v||^2 through ``impl="ref"``."""
    t0 = time.perf_counter()
    lr = lanczos(op, v0, CX_REF_LANCZOS_K)
    ev, _ = tridiag_eigh(lr.alphas[:int(lr.nvalid)],
                         lr.betas[:max(int(lr.nvalid) - 1, 0)])
    lam, top = float(ev[0]), float(ev[-1])
    spectrum = (lam - CX_CHEB_BELOW, top + CX_CHEB_BELOW)
    execution.reset_launch_counts()
    res = chebfd(op, (lam - CX_CHEB_BELOW, lam + CX_CHEB_ABOVE),
                 block_size=8, degree=CX_CHEB_DEGREE, sweeps=CX_CHEB_SWEEPS,
                 spectrum=spectrum)
    sync()
    launches = _counts(("sellcs_spmv", "tsmttsm", "tsmm"))
    rel = abs(res.eigenvalues[0] - lam) / lam
    print(f"[complex solves] ChebFD complex128 window ({lam:.12f} - "
          f"{CX_CHEB_BELOW}, + {CX_CHEB_ABOVE}), degree {CX_CHEB_DEGREE}, "
          f"{CX_CHEB_SWEEPS} sweeps, block 8, spectrum from a Lanczos of "
          f"{CX_REF_LANCZOS_K} steps ({spectrum[0]:.6f}, {spectrum[1]:.6f}):"
          f" Ritz values {np.array2string(res.eigenvalues[:4], precision=12)}"
          f" residual norms {np.array2string(res.residuals[:4], precision=2)};"
          f" lowest {rel:.2e} relative off Lanczos's lambda_min "
          f"{lam:.12f}; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    require(rel <= CX_CHEB_TOL, f"complex ChebFD: lowest Ritz value {rel:.2e} "
            f"relative off lambda_min")

    a, gam = (spectrum[1] - spectrum[0]) / 2, (spectrum[1] + spectrum[0]) / 2
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    bits = torch.rand((A.nrows, CX_KPM_PROBES), generator=gen,
                      device=DEVICE) < 0.5
    v = A.permute(torch.where(bits, 1.0, -1.0).to(torch.float32)
                  / np.sqrt(A.nrows)).to(torch.complex128)
    Av = (make_operator(A, impl="ref").mv(v) - gam * v) / a
    n_av = (Av.conj() * Av).real.sum(0)
    n_v = (v.conj() * v).real.sum(0)
    want = float((2 * n_av - n_v).mean())
    lim = 4 * 2.0 ** -24 * float((2 * n_av + n_v).mean())
    for fused in (True, False):
        execution.reset_launch_counts()
        mus = kpm_dos_moments(op, CX_KPM_MOMENTS, n_probes=CX_KPM_PROBES,
                              spectrum=spectrum, seed=0, fused=fused)
        sync()
        mu2 = float(mus[2])
        print(f"[complex solves] KPM complex128 {CX_KPM_PROBES} probes "
              f"fused={fused}: mu_2 {mu2:.10f}, 2||A_s v||^2 - ||v||^2 "
              f"{want:.10f} (through impl='ref'): {abs(mu2 - want):.2e} off "
              f"(bound {lim:.2e}: the moments are float32); mu_0 "
              f"{float(mus[0]):.7f}; B1 launches "
              f"{execution.launch_counts().get(KERNEL, 0)}  [{card}]")
        require(abs(mu2 - want) <= lim,
                f"complex KPM fused={fused}: mu_2 {mu2} against {want}")
        require(abs(float(mus[0]) - 1.0) <= 1e-6,
                f"complex KPM fused={fused}: mu_0 = {float(mus[0])}")
    if DEVICE == "cuda":
        _cx_eigen_timing(A, op, a, gam, lam, card)
    return {"lambda_min": lam}


def _cx_eigen_timing(A, op, a, gam, lam, card) -> None:
    """ms per B1 launch as ChebFD and KPM issue it on the phased matrix
    in complex128 (CUDA events over back-to-back calls): ChebFD's filter
    of CX_CHEB_DEGREE on a block of 8 (one launch a degree, its vector
    passes included) and its recurrence's B1 call alone, and one KPM
    moment step on CX_KPM_PROBES probes (one launch, its moments
    included)."""
    g = torch.Generator(device=DEVICE).manual_seed(CX_SEED + 3)
    V = _cx_randn((A.nrows_pad, 8), torch.complex128, g)
    deg = CX_CHEB_DEGREE
    lo_t, hi_t = lam - CX_CHEB_BELOW, lam + CX_CHEB_ABOVE
    filt = time_ms(lambda: chebfd_mod._cheb_filter(op, V, deg, a, gam, lo_t,
                                                   hi_t), warmup=1, iters=3)
    opts = SpmvOpts(alpha=2.0 / a, beta=-1.0, gamma=gam)
    one = time_ms(lambda: op.mv_fused(V, y=V, opts=opts))
    w = _cx_randn((A.nrows_pad, CX_KPM_PROBES), torch.complex128, g)
    mu = torch.ones(CX_KPM_PROBES, dtype=torch.float32, device=DEVICE)
    step = time_ms(lambda: kpm_mod.moment_step(op, w, w, 2.0 / a, gam, mu,
                                               mu))
    print(f"[complex solves] ms per B1 launch, complex128 phased laplace3d"
          f"({NX}): ChebFD's filter of degree {deg} on a block of 8 "
          f"{filt / deg:.4f} ms a launch ({filt:.3f} ms a filter, its vector "
          f"passes included), its recurrence's B1 call alone {one:.4f} ms; "
          f"one KPM moment step on {CX_KPM_PROBES} probes {step:.4f} ms "
          f"(one launch, its moments included)  [{card}]")



# ---------------------------------------------------------------- phase 13e
#: slice 21: mixed operand dtypes of B1-B4 on the card.  The pairs (first
#: operand, second; tests/test_torch_mixed_dtypes.py holds the same pairs
#: against the JAX package on the CPU), B1's (compute, stored, x) dtypes,
#: the grid's rows, widths and block sizes, B2 past the shared-memory
#: limit (each dtype's width), and the two solves' problems
MIXED_PAIRS = ((torch.float64, torch.float32), (torch.float32, torch.float64),
               (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16),
               (torch.float16, torch.float64),
               (torch.complex128, torch.float64),
               (torch.float64, torch.complex128),
               (torch.complex64, torch.float32),
               (torch.float32, torch.complex64),
               (torch.complex64, torch.complex128),
               (torch.complex128, torch.complex64),
               (torch.complex64, torch.float64),
               (torch.float64, torch.complex64),
               (torch.bfloat16, torch.complex64))
MIXED_B1 = ((torch.float64, torch.float64, torch.float32),
            (torch.float32, torch.float32, torch.float64),
            (torch.complex128, torch.complex128, torch.float64),
            (torch.float64, torch.float64, torch.complex128),
            (torch.float32, torch.float32, torch.complex64),
            (torch.complex64, torch.complex64, torch.complex128),
            (torch.complex128, torch.complex128, torch.complex64),
            (torch.float64, torch.float64, torch.complex64),
            (torch.float32, torch.bfloat16, torch.complex64),
            (torch.float32, torch.float16, torch.complex128))
MIXED_N, MIXED_MK, MIXED_BS, MIXED_B1_NX = 4099, ((16, 16), (96, 72)), \
    (32, 128), 24
MIXED_WIDE = ((torch.float32, 8400), (torch.complex64, 4200))
MIXED_WIDE_N = 40
MIXED_PCG_NX, MIXED_PCG_BS = 512, 32
#: the two mixed solves once on the host and once on the card, at sizes
#: the host solves in seconds: laplace3d(MIXED_HOST_NX) and
#: anisotropic_laplace2d(MIXED_HOST_PCG_NX) (the full-size solves are
#: compared with the plain versions on the card)
MIXED_HOST_NX, MIXED_HOST_PCG_NX = 40, 128


def _mixed_check(got, want, out, tag, worst, precision=None) -> None:
    """The result dtype is ``out`` and max |kernel - plain| at most 1e-12
    (64-bit results) or 1e-5 (32-bit) of max |plain|, the plain version
    in float64 (complex128); ``precision`` names the dtype whose width
    sets the tolerance where it is not ``out`` (B1's dots, summed in
    float64 from a 32-bit result)."""
    tol = (1e-12 if (precision or out) in (torch.float64, torch.complex128)
           else 1e-5)
    require(got.dtype == out, f"mixed {tag}: dtype {got.dtype}, not {out}")
    scale = float(want.abs().max())
    err = float((got.to(want.dtype) - want).abs().max())
    ratio = err / (tol * scale) if scale else 0.0
    require(ratio <= 1.0, f"mixed {tag}: error {err:.3e} is {ratio:.2f} of "
            f"{tol} x {scale:.3e}")
    w = worst.setdefault(tag.split(" ")[0], [0.0, ""])
    if ratio >= w[0]:
        w[:] = [ratio, tag]


def _wide_of(dt):
    return torch.complex128 if dt.is_complex else torch.float64


def _mixed_grid(g, rng, worst) -> int:
    """Every new pair of B1-B4 against the plain versions on the same
    inputs, and B2 past shared memory (column blocks: past a lowered stage
    limit equal to the bits of the call that fits, and past the real
    limit against the plain version)."""
    n_cases = 0
    for a, b in MIXED_PAIRS:
        out = torch.promote_types(a, b)
        w = _wide_of(out)
        name = f"{str(a)[6:]} x {str(b)[6:]}"
        cf = (0.5 - 0.5j, 2.0j) if out.is_complex else (0.5, -2.0)
        for m, k in MIXED_MK:
            V, W = _cx_randn((MIXED_N, m), a, g), _cx_randn((MIXED_N, k), b, g)
            X = _cx_randn((m, k), out, g)
            for kahan in (False, True):
                _mixed_check(tsmttsm(V, W, X, *cf, kahan=kahan),
                             tsmttsm_ref(V.to(w), W.to(w), X.to(w), *cf),
                             out, f"B2 {name} m={m} k={k} kahan={kahan}",
                             worst)
            X = _cx_randn((m, k), b, g)
            Wo = _cx_randn((MIXED_N, k), out, g)
            _mixed_check(tsmm(V, X, Wo, *cf), tsmm_ref(
                V.to(w), X.to(w), Wo.to(w), *cf), out,
                f"B3 {name} m={m} k={k}", worst)
            n_cases += 3
        for bs in MIXED_BS:
            blocks, x = _cx_randn((9, bs, bs), a, g), _cx_randn((9 * bs, 3),
                                                                b, g)
            _mixed_check(block_jacobi_apply(blocks, x), block_diag_matmul_ref(
                blocks.to(w), x.to(w)), out, f"B4 {name} bs={bs}", worst)
            n_cases += 1
    r, c, v, n = laplace3d(MIXED_B1_NX)
    for ct, st, xd in MIXED_B1:
        vals = np.asarray(v, np.float64)
        if ct.is_complex:
            vals = vals * np.exp(1j * rng.uniform(0, 2 * np.pi, vals.size))
        kw = dict(C=32, sigma=64, dtype=ct)
        if st != ct:
            kw["store_dtype"] = st
        A = from_coo(r, c, vals, (n, n), device=DEVICE, **kw)
        out = torch.promote_types(ct, xd)
        cf = dict(alpha=0.5 - 0.25j, beta=-1.0 + 0.5j, gamma=0.25j,
                  delta=2.0, eta=0.5 + 1j) if out.is_complex else dict(
            alpha=0.5, beta=-1.0, gamma=0.25, delta=2.0, eta=0.5)
        for b in (1, 4, 16):
            x, y, z = (_cx_randn((A.nrows_pad, b), xd, g) for _ in range(3))
            for dots in (False, True):
                opts = SpmvOpts(**cf, dot_yy=dots, dot_xy=dots, dot_xx=dots)
                got = sellcs_spmv(A, x, y, z, opts)
                want = sellcs_spmv_ref(A, x.to(out), y.to(out), z.to(out),
                                       opts)
                tag = (f"B1 {str(st)[6:]}/{str(ct)[6:]} x {str(xd)[6:]} "
                       f"b={b} dots={dots}")
                for i in range(2 if not dots else 3):
                    _mixed_check(got[i], want[i], want[i].dtype, tag, worst,
                                 precision=out)
                n_cases += 1
    # B2 past shared memory: a lowered limit (the bits of the call that
    # fits), then the real one
    for dt in (torch.float32, torch.complex64):
        m, k = 300, 200
        V, W, X = (_cx_randn(s, dt, g) for s in ((MIXED_N, m), (MIXED_N, k),
                                                 (m, k)))
        cf = (0.5 - 0.5j, 2.0j) if dt.is_complex else (0.5, -2.0)
        whole = [tsmttsm(V, W, X, *cf, kahan=kahan) for kahan in (False, True)]
        saved = (b2.STAGE_BYTES, b2.STAGE_LIMIT)
        b2.STAGE_BYTES = 1024
        b2.STAGE_LIMIT = b2.stage_smem(m, k, dt.itemsize, dt) // 2
        blocks = b2.column_blocks(m, k, dt.itemsize, dt)
        for kahan in (False, True):
            got = tsmttsm(V, W, X, *cf, kahan=kahan)
            require(torch.equal(got, whole[kahan]) or DEVICE == "cpu",
                    f"mixed B2 column blocks {dt} kahan={kahan}: not the "
                    f"bits of the whole call")
        b2.STAGE_BYTES, b2.STAGE_LIMIT = saved
        _mixed_check(got, tsmttsm_ref(V.to(_wide_of(dt)), W.to(_wide_of(dt)),
                                      X.to(_wide_of(dt)), *cf), dt,
                     f"B2split {str(dt)[6:]} {m}x{k} as {blocks}", worst)
        n_cases += 2
    for dt, width in MIXED_WIDE:
        blocks = b2.column_blocks(width, width, dt.itemsize, dt)
        require(blocks != (width, width), f"mixed B2 {dt} m=k={width}: "
                f"within the limit")
        V, W = (_cx_randn((MIXED_WIDE_N, width), dt, g) for _ in range(2))
        _mixed_check(tsmttsm(V, W, kahan=True), tsmttsm_ref(
            V.to(_wide_of(dt)), W.to(_wide_of(dt))), dt,
            f"B2wide {str(dt)[6:]} m=k={width} as {blocks}", worst)
        n_cases += 1
        del V, W
    return n_cases


class _PlainBlockJacobi:
    """A block-Jacobi preconditioner's blocks applied by the plain version
    (``block_diag_matmul_ref``), the path the CPU runs."""

    def __init__(self, M):
        self.inv_blocks = M.inv_blocks

    def apply(self, r):
        r2 = r[:, None] if r.ndim == 1 else r
        y = block_diag_matmul_ref(self.inv_blocks, r2)
        return y[:, 0] if r.ndim == 1 else y


def _mixed_solve(label, run, plain, relres, tol, kernels, card):
    """A solve on the kernels against the same solve on the plain versions
    (the CPU's path, on the card: a CPU run of these sizes takes minutes):
    converged, the plain run's count within one, every column's true
    relative residual at most 10 tol, and each kernel launched."""
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = run()
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(kernels)
    ref = plain()
    rel = relres(res.x)
    it, it_plain = int(res.iters), int(ref.iters)
    print(f"[mixed] {label}: {it} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(it, 1):.3f} ms/iter), the plain versions "
          f"{it_plain}, converged={bool(torch.as_tensor(res.converged).all())}"
          f", dtype {str(res.x.dtype)[6:]}, true rel residuals "
          f"{' '.join(f'{e:.2e}' for e in rel.reshape(-1).tolist())} (tol "
          f"{tol}), launches {launches}  [{card}]")
    require(bool(torch.as_tensor(res.converged).all())
            and bool(torch.as_tensor(ref.converged).all()),
            f"mixed {label}: not converged")
    require(abs(it - it_plain) <= 1, f"mixed {label}: {it} iterations, the "
            f"plain versions {it_plain}")
    require(float(rel.max()) <= 10 * tol, f"mixed {label}: true residual "
            f"{float(rel.max())} > {10 * tol}")
    require(all(v >= it for v in launches.values()) or DEVICE == "cpu",
            f"mixed {label}: launches {launches} for {it} iterations")
    return dict(iters=it, plain_iters=it_plain, secs=secs, launches=launches)


def _mixed_b1_row(A, card):
    """B1 at b = 4 with <p, Ap> on laplace3d(NX)'s real float64 values and
    complex128 x (a real value stream under a complex compute dtype):
    kernel, plain version and the bytes bound."""
    g = torch.Generator(device=DEVICE).manual_seed(131)
    x = _cx_randn((A.nrows_pad, 4), torch.complex128, g)
    opts = SpmvOpts(dot_xy=True)
    got = sellcs_spmv(A, x, opts=opts)
    want = sellcs_spmv_ref(A, x, opts=opts)
    worst = {}
    _mixed_check(got[0], want[0], torch.complex128, "B1row y", worst)
    _mixed_check(got[2], want[2], torch.complex128, "B1row dots", worst)
    ms = time_ms(lambda: sellcs_spmv(A, x, opts=opts))
    plain_ms = time_ms(lambda: sellcs_spmv_ref(A, x, opts=opts), warmup=1,
                       iters=3)
    nbytes = _spmv_bytes(A, x, got[0], got[2])
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[mixed] sellcs_spmv float64 values x complex128 b=4 <p, Ap> "
          f"laplace3d({NX}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB), "
          f"{100 * bound_ms / ms:.1f}% of bound, max abs err "
          f"{float((got[0] - want[0]).abs().max()):.3e}  [{card}]")


def _mixed_host_against_card(card):
    """The two mixed solves (column CG, complex128 right-hand side, real
    laplace3d; block-Jacobi PCG, real blocks, complex right-hand side) on
    the host and on the card from the same inputs: the host's iteration
    count within one, the card launching B1 (and B4) every iteration."""
    out = {}
    rng = np.random.default_rng(22)
    r, c, v, n = laplace3d(MIXED_HOST_NX)
    b_col = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    ra, ca, va, na = anisotropic_laplace2d(MIXED_HOST_PCG_NX,
                                           epsilon=PRECOND_EPS)
    b_pcg = rng.standard_normal(na) + 1j * rng.standard_normal(na)
    for label, coo, b, kw, bs, kernels in (
            (f"column CG laplace3d({MIXED_HOST_NX})", (r, c, v, n), b_col,
             dict(tol=1e-8, maxiter=3000), 0, ("sellcs_spmv",)),
            (f"block-Jacobi PCG anisotropic_laplace2d({MIXED_HOST_PCG_NX})",
             (ra, ca, va, na), b_pcg, dict(tol=PCG_TOL, maxiter=8 * na),
             MIXED_PCG_BS, PRECOND_KERNELS)):
        iters, launches = {}, {}
        for dev in ("cpu", DEVICE):
            A = from_coo(coo[0], coo[1], coo[2], (coo[3], coo[3]),
                         C=PRECOND_C, sigma=1, dtype=np.float64, device=dev)
            M = (make_preconditioner(f"block_jacobi:{bs}", matrix=A)
                 if bs else None)
            execution.reset_launch_counts()
            res = cg(make_operator(A), A.permute(
                torch.from_numpy(b).to(dev)), M=M, **kw)
            sync()
            require(bool(torch.as_tensor(res.converged).all())
                    and res.x.dtype == torch.complex128,
                    f"mixed {label} on {dev}: not converged in complex128")
            iters[dev] = int(res.iters)
            launches[dev] = _counts(kernels)
        print(f"[mixed] {label} complex128 b: {iters['cpu']} iterations on "
              f"the host, {iters[DEVICE]} on the card, card launches "
              f"{launches[DEVICE]}  [{card}]")
        require(abs(iters["cpu"] - iters[DEVICE]) <= 1,
                f"mixed {label}: host {iters['cpu']}, card {iters[DEVICE]}")
        require(DEVICE == "cpu" or all(
            k >= iters[DEVICE] for k in launches[DEVICE].values()),
                f"mixed {label}: launches {launches[DEVICE]}")
        out[label] = dict(iters=iters, launches=launches[DEVICE])
    return out


def phase_mixed_dtypes(fw, card):
    """Slice 21: every new dtype pair of B1-B4 and B2's column blocks
    against the plain versions, B1's real values under complex128 x
    timed, and the two solves the pairs open: column CG with a complex128
    right-hand side on the real laplace3d(NX), and block-Jacobi PCG with
    real blocks on a complex right-hand side on
    anisotropic_laplace2d(MIXED_PCG_NX), each against the plain
    versions' iteration count."""
    rng = np.random.default_rng(21)
    g = torch.Generator(device=DEVICE).manual_seed(21)
    worst = {}
    t0 = time.perf_counter()
    n_cases = _mixed_grid(g, rng, worst)
    sync()
    for kern, (ratio, tag) in sorted(worst.items()):
        print(f"[mixed grid] {kern:7s} worst {ratio:.3f} of its tolerance "
              f"(at {tag})")
    print(f"[mixed grid] {n_cases} cases ({len(MIXED_PAIRS)} pairs of B2, B3 "
          f"and B4, {len(MIXED_B1)} of B1, B2 past shared memory) within "
          f"1e-12 (64-bit results) or 1e-5 (32-bit) of the plain versions, "
          f"in {time.perf_counter() - t0:.1f} s")
    A = fw["A64"]
    _mixed_b1_row(A, card)
    bc = A.permute(_cx_randn((A.nrows, WIDTH // 4), torch.complex128, g))
    col = _mixed_solve(
        f"column CG laplace3d({NX}) float64 matrix, complex128 b (b=4)",
        lambda: cg(make_operator(A), bc, tol=1e-8, maxiter=3000),
        lambda: cg(make_operator(A, impl="ref"), bc, tol=1e-8,
                   maxiter=3000),
        lambda x: _cx_relres(A, bc, x), 1e-8, ("sellcs_spmv",), card)
    del bc
    Ap = _aniso(MIXED_PCG_NX)
    t1 = time.perf_counter()
    M = make_preconditioner(f"block_jacobi:{MIXED_PCG_BS}", matrix=Ap)
    setup = time.perf_counter() - t1
    bp = Ap.permute(_cx_randn((Ap.nrows,), torch.complex128, g))
    print(f"[mixed] block-Jacobi set-up bs={MIXED_PCG_BS}: {setup:.1f} s, "
          f"real blocks {str(M.inv_blocks.dtype)[6:]}")
    require(not M.inv_blocks.is_complex(), "mixed PCG: complex blocks")
    pcg = _mixed_solve(
        f"block-Jacobi PCG anisotropic_laplace2d({MIXED_PCG_NX}) float64 "
        f"blocks of {MIXED_PCG_BS}, complex128 b",
        lambda: cg(make_operator(Ap), bp, tol=PCG_TOL, maxiter=8 * Ap.nrows,
                   M=M),
        lambda: cg(make_operator(Ap, impl="ref"), bp, tol=PCG_TOL,
                   maxiter=8 * Ap.nrows, M=_PlainBlockJacobi(M)),
        lambda x: _cx_relres(Ap, bp[:, None], x[:, None]), PCG_TOL,
        PRECOND_KERNELS, card)
    return dict(column=col, pcg=pcg, host=_mixed_host_against_card(card))



# ---------------------------------------------------------------- phase 13d
def phase_complex_timing(cx, card):
    """B1–B5 with complex values at the main shapes (B1 and B2 in
    complex128 and complex64, B3 and B4 in complex128): kernel, plain
    version, one PyTorch call computing the same function, and the bound
    (the bytes over the data sheet's device-memory rate, as for the real
    rows, or the operations over the peak of the parts' type, whichever is
    larger; the bytes over the measured rate printed beside it).  Each
    result is held against its plain version before it is timed: B1
    within the real kernels' tolerances of max|y|, B2–B4 by
    :func:`_cx_check`."""
    A = cx["A"]
    csr = _library_csr(A, cx["coo"])
    g = torch.Generator(device=DEVICE).manual_seed(CX_SEED + 2)
    f64 = torch.float64
    rows = {}

    def row(key, label, kern, plain, lib, nbytes, flops, err, slow=False,
            peak=PEAK_FLOPS[f64]):
        ms = time_ms(kern)
        plain_ms = time_ms(plain, warmup=1 if slow else 3,
                           iters=2 if slow else 20)
        lib_ms = None if lib is None else time_ms(lib)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * flops / peak
        bound_ms = max(bytes_ms, ops_ms)
        measured_ms = 1e3 * nbytes / CX_MEASURED_BYTES_PER_S
        lib_text = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[complex] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_text}, bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e9:.1f} GB/s; "
              f"operations {ops_ms:.4f} ms), {100 * bound_ms / ms:.1f}% of "
              f"bound; at the measured {CX_MEASURED_BYTES_PER_S / 1e9:.1f} "
              f"GB/s the bytes take {measured_ms:.4f} ms "
              f"({100 * measured_ms / ms:.1f}%); max abs err {err:.3e}  "
              f"[{card}]")
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, err=err,
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations")

    for ct in CX_DTYPES:
        Ac = A if ct == torch.complex128 else dataclasses.replace(
            A, vals=A.vals.to(ct))
        r, c, hv, n = cx["coo"]
        csr_c = csr if ct == torch.complex128 else _library_csr(
            A, (r, c, np.asarray(hv, np.complex64), n))
        tol = TOL[CX_REAL[ct]]
        for b in CX_TIMED_B:
            x = _cx_randn((A.nrows_pad, b), ct, g)
            opts = SpmvOpts(dot_xy=b in CX_TIMED_DOTS)   # as the solvers ask
            yk, _, dk = sellcs_spmv(Ac, x, opts=opts)
            yr, _, dr = sellcs_spmv_ref(Ac, x, opts=opts)
            require(rel_err(yk, yr) <= tol["vec"]
                    and rel_err(dk, dr) <= tol["dots"],
                    f"complex timing: B1 {ct} b={b} off its plain version")
            lib_err = rel_err(csr_c @ x, yk)
            require(lib_err <= tol["vec"], f"complex timing: the library "
                    f"product is {lib_err:.2e} off at {ct} b={b}")
            err = float((yk.to(torch.complex128) - yr).abs().max())
            row(("sellcs_spmv", ct, b),
                f"sellcs_spmv {str(ct)[6:]} b={b} "
                f"{'<p, Ap>' if opts.dot_xy else 'no dots'} phased "
                f"laplace3d({NX})",
                lambda: sellcs_spmv(Ac, x, opts=opts),
                lambda: sellcs_spmv_ref(Ac, x, opts=opts), lambda: csr_c @ x,
                _spmv_bytes(Ac, x, yk, dk), 8.0 * A.nnz * b, err,
                peak=PEAK_FLOPS[CX_REAL[ct]])
            del x, yk, yr
        del Ac, csr_c
    nt = A.nrows_pad
    flops = 8.0 * nt * CX_WIDTH * CX_WIDTH
    worst = [0.0, "", 0.0]
    # B2 as block CG and block MINRES (Kahan) and ChebFD (the plain sum)
    # call it, in both complex types
    for ct in CX_DTYPES:
        V, W = (_cx_randn((nt, CX_WIDTH), ct, g) for _ in range(2))
        Vd, Wd = V.to(torch.complex128), W.to(torch.complex128)
        scale = Vd.abs().T @ Wd.abs()
        for kahan in (True, False):
            want = tsmttsm_ref(Vd, Wd, kahan=kahan)
            got = tsmttsm(V, W, kahan=kahan)
            depth = (kahan_depth(nt, CX_WIDTH, CX_WIDTH, CX_REAL[ct], ct)
                     if kahan else summation_depth(nt, CX_WIDTH, CX_WIDTH, ct))
            err = _cx_check(got, want, scale, ct, depth, nt,
                            f"B2 {str(ct)[6:]} kahan={kahan} n={nt}", worst)
            row(("tsmttsm", ct, kahan),
                f"tsmttsm {'Kahan' if kahan else 'plain sum'} {str(ct)[6:]} "
                f"n={nt} m=k={CX_WIDTH}",
                lambda: tsmttsm(V, W, kahan=kahan),
                lambda: tsmttsm_ref(V, W, kahan=kahan), lambda: V.mH @ W,
                _nbytes(V, W, got), flops, err, slow=kahan,
                peak=PEAK_FLOPS[CX_REAL[ct]])
        del V, W, Vd, Wd, scale
    V, W = (_cx_randn((nt, CX_WIDTH), torch.complex128, g) for _ in range(2))
    X = _cx_randn((CX_WIDTH, CX_WIDTH), torch.complex128, g)
    Va, Wa = V.abs(), W.abs()
    got = tsmm(V, X, W, 1.0, 1.0)
    err = _cx_check(got, tsmm_ref(V, X, W, 1.0, 1.0), Va @ X.abs() + Wa,
                    torch.complex128, CX_WIDTH, CX_WIDTH,
                    f"B3 with W n={nt}", worst)
    row(("tsmm", "with W"), f"tsmm with W complex128 n={nt} m=k={CX_WIDTH}",
        lambda: tsmm(V, X, W, 1.0, 1.0),
        lambda: tsmm_ref(V, X, W, 1.0, 1.0),
        lambda: torch.addmm(W, V, X, beta=1.0, alpha=1.0),
        _nbytes(V, X, W, got), flops, err)
    got = tsmm(V, X)
    err = _cx_check(got, tsmm_ref(V, X), Va @ X.abs(), torch.complex128,
                    CX_WIDTH, CX_WIDTH, f"B3 without W n={nt}", worst)
    row(("tsmm", "without W"),
        f"tsmm without W complex128 n={nt} m=k={CX_WIDTH}",
        lambda: tsmm(V, X), lambda: tsmm_ref(V, X), lambda: torch.mm(V, X),
        _nbytes(V, X, got), flops, err)
    del V, W, Va, Wa
    # B5's complex variant at the shape of the real B5 row (n x 4), with
    # all three dots; no single PyTorch call computes it.  Two complex
    # products and a sum (14 operations an entry), three dot terms (24)
    for ct in CX_DTYPES:
        x5, y5 = (_cx_randn((nt, PRECOND_WIDTH), ct, g) for _ in range(2))
        a5, b5 = 0.5 - 1.5j, -1.0 + 0.25j
        worst5 = [0.0, ""]
        _b5_cx_check(x5, y5, a5, b5, (True, True, True),
                     f"{str(ct)[6:]} n={nt}", worst5)
        rows[("fused_axpby_dots", ct)] = _b5_timed(
            x5, y5, a5, b5, f"[complex] fused_axpby_dots {str(ct)[6:]}",
            PEAK_FLOPS[CX_REAL[ct]], 38.0, worst5, card)
        del x5, y5
    nb, bs = PRECOND_NX * PRECOND_NX // PRECOND_C, PRECOND_C
    B = _cx_randn((nb, bs, bs), torch.complex128, g)
    x = _cx_randn((nb * bs, PRECOND_WIDTH), torch.complex128, g)
    got = block_jacobi_apply(B, x)
    err = _cx_check(got, block_diag_matmul_ref(B, x),
                    block_diag_matmul_ref(B.abs(), x.abs()),
                    torch.complex128, bs, bs,
                    f"B4 nblocks={nb} bs={bs}", worst)
    Bv, xv = B.view(nb, bs, bs), x.view(nb, bs, PRECOND_WIDTH)
    row(("block_diag_matmul", bs),
        f"block_diag_matmul complex128 nblocks={nb} bs={bs} b={PRECOND_WIDTH}",
        lambda: block_jacobi_apply(B, x), lambda: block_diag_matmul_ref(B, x),
        lambda: torch.bmm(Bv, xv), _nbytes(B, x, got),
        8.0 * nb * bs * bs * PRECOND_WIDTH, err)
    print(f"[complex] B2 (plain sum and Kahan), B3 and B4 at these shapes "
          f"within sqrt(2) (2 depth + 3) u sum|a||b| of their plain "
          f"versions: worst {worst[0]:.3f} of the bound (at {worst[1]}); B5 "
          f"within its complex grid bound  [{card}]")
    return rows


def phase_b5_residual(pcg, card) -> int:
    """B5 on its one path in this script: the true residual of the PCG
    solution, ``r = b - A x`` with ``<r, r>`` and ``<b, b>`` in one sweep,
    held against the plain SpMV's residual.  Returns B5's launches."""
    op, b, x = pcg["op"], pcg["b"], pcg["res"].x
    execution.reset_launch_counts()
    Ax = op.mv(x)
    r, dots = fused_axpby_dots(b, Ax, 1.0, -1.0, dot_yy=True, dot_xx=True)
    relres = torch.sqrt(dots[0] / dots[2])
    sync()
    launches = execution.launch_counts().get("fused_axpby_dots", 0)
    plain = _colwise_relres(pcg["A"], b, x)
    diff = float(((relres - plain).abs() / plain).max())
    print(f"[b5 path] PCG true relative residual through fused_axpby_dots: "
          f"{' '.join(f'{v:.6e}' for v in relres.tolist())}; through the "
          f"plain SpMV: {' '.join(f'{v:.6e}' for v in plain.tolist())}; "
          f"max relative difference {diff:.2e}; fused_axpby_dots launches "
          f"{launches}")
    # r is the difference of nearly equal vectors (|r| ~ 1e-8 |b|), so
    # the two SpMVs' different summation orders show at ~1e-8 of |r|
    require(diff <= 1e-4, f"B5 residual differs from plain by {diff}")
    require(launches == 1 or DEVICE == "cpu",
            f"fused_axpby_dots launches {launches} != 1")
    return launches


def _m_relres(M, A, b, x) -> torch.Tensor:
    """True relative residual in the M-norm, sqrt(<r, M r> / <b, M b>):
    the norm preconditioned MINRES converges in (M Hermitian)."""
    Ax, _, _ = sellcs_spmv_ref(A, x)
    r = b - Ax

    def mdot(u):
        return (u.conj() * M.apply(u)).sum(0).real
    return torch.sqrt(mdot(r) / mdot(b))


def phase_precond_minres(pcg, card) -> None:
    A, op, M = pcg["A"], pcg["op"], pcg["M"]
    g = torch.Generator(device=DEVICE).manual_seed(10)
    b = A.permute(torch.randn(A.nrows, PRECOND_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    maxiter = 8 * A.nrows
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = minres(op, b, tol=PMINRES_TOL, maxiter=maxiter, M=M)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(PRECOND_KERNELS)
    it = res.iters
    d = dropped("minres_precond")
    mrel = _m_relres(M, A, b, res.x)
    relres = _colwise_relres(A, b, res.x)
    print(f"[pminres] block_jacobi MINRES f64 b={PRECOND_WIDTH} tol "
          f"{PMINRES_TOL}: {it} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(it, 1):.3f} ms/iter), converged="
          f"{bool(res.converged.all())}; true relative residual per column "
          f"in the M-norm {' '.join(f'{v:.2e}' for v in mrel.tolist())}, in "
          f"the 2-norm {' '.join(f'{v:.2e}' for v in relres.tolist())}; "
          f"launches {launches} (per iteration 1 sellcs_spmv, 1 "
          f"block_diag_matmul; init 1 and 2; {d} discarded iteration)  "
          f"[{card}]")
    require(bool(res.converged.all()), "PMINRES: not converged")
    require(float(mrel.max()) <= 10 * PMINRES_TOL,
            f"PMINRES: M-norm residual {float(mrel.max())} > "
            f"{10 * PMINRES_TOL}")
    require(d <= 1, f"PMINRES: {d} discarded iterations in one chunk")
    want = {"sellcs_spmv": it + d + 1, "block_diag_matmul": it + d + 2}
    require(launches == want or DEVICE == "cpu",
            f"PMINRES launches {launches} != {want}")
    st = minres_init(op, b, tol=PMINRES_TOL, maxiter=maxiter, M=M)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = minres_step(op, st, 256, M=M)
    ch = minres_finalize(st)
    same = ch.iters == it and torch.equal(ch.x, res.x)
    print(f"[pminres] as minres_step chunks of 256: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked PMINRES differs from the monolithic one")


def phase_chebyshev_pcg(card) -> None:
    """Chebyshev-preconditioned CG (degree 4, spectrum from the port's
    Lanczos): B1 only, (degree - 1) SpMVs per apply plus the outer one."""
    A = _aniso(CHEB_PCG_NX)
    op = make_operator(A)
    t0 = time.perf_counter()
    spectrum = lanczos_extrema(op)
    M = make_preconditioner("chebyshev:4", op=op, spectrum=spectrum)
    sync()
    t_setup = time.perf_counter() - t0
    g = torch.Generator(device=DEVICE).manual_seed(11)
    b = A.permute(torch.randn(A.nrows, PRECOND_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=PCG_TOL, maxiter=8 * A.nrows, M=M)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(PRECOND_KERNELS)
    it = res.iters
    d = dropped("cg_precond")
    relres = _colwise_relres(A, b, res.x)
    print(f"[cheb pcg] chebyshev:4 PCG f64 b={PRECOND_WIDTH} tol {PCG_TOL}, "
          f"spectrum ({spectrum[0]:.6g}, {spectrum[1]:.6g}) -> interval "
          f"({M.lo:.6g}, {M.hi:.6g}), set-up {t_setup:.2f} s: {it} iterations"
          f" in {secs:.3f} s ({1e3 * secs / max(it, 1):.3f} ms/iter), "
          f"converged={bool(res.converged.all())}, max true relative "
          f"residual {float(relres.max()):.2e}, launches {launches} "
          f"(4 sellcs_spmv per iteration and at init; {d} discarded "
          f"iteration)  [{card}]")
    require(bool(res.converged.all()), "Chebyshev PCG: not converged")
    require(float(relres.max()) <= 10 * PCG_TOL,
            f"Chebyshev PCG: true residual {float(relres.max())}")
    require(d <= 1, f"Chebyshev PCG: {d} discarded iterations in one chunk")
    want = {"sellcs_spmv": M.degree * (it + d + 1), "block_diag_matmul": 0}
    require(launches == want or DEVICE == "cpu",
            f"Chebyshev PCG launches {launches} != {want}")


# ----------------------------------------------------------------- phase 15
def phase_precond_timing(pcg, card):
    """B4 at the PCG main shape (f64, and f32 / bf16-block rows beside
    it) and B5 at n = 4,194,304, bw = 4, f64 with all three dots: kernel,
    plain version, one PyTorch call where one computes the same function,
    and the bound."""
    inv = pcg["M"].inv_blocks
    nb, bs, _ = inv.shape
    n = nb * bs
    g = torch.Generator(device="cuda").manual_seed(12)
    x64 = torch.randn(n, PRECOND_WIDTH, generator=g, dtype=torch.float64,
                      device="cuda")
    rows = {}
    cases = [("f64", inv, x64), ("f32", inv.float(), x64.float()),
             ("bf16 blocks, f32 x", inv.to(torch.bfloat16), x64.float())]
    for label, B, x in cases:
        worst = [0.0, "", 0.0]
        err = _b4_check(B, x, f"timing {label}", worst)
        ms = time_ms(lambda: block_jacobi_apply(B, x))
        plain_ms = time_ms(lambda: block_diag_matmul_ref(B, x), warmup=3,
                           iters=20)
        lib_ms = None
        if B.dtype == x.dtype:       # one call computes it: a batched GEMM
            Bv, xv = B.view(nb, bs, bs), x.view(nb, bs, PRECOND_WIDTH)
            lib_ms = time_ms(lambda: torch.bmm(Bv, xv))
        out_bytes = n * PRECOND_WIDTH * torch.finfo(
            torch.promote_types(B.dtype, x.dtype)).bits // 8
        nbytes = _nbytes(B, x) + out_bytes
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        acc = torch.float64 if label == "f64" else torch.float32
        ops_ms = 1e3 * 2.0 * nb * bs * bs * PRECOND_WIDTH / PEAK_FLOPS[acc]
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[timing] block_diag_matmul {label} nblocks={nb} bs={bs} "
              f"b={PRECOND_WIDTH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library(bmm) "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB; operations "
              f"{ops_ms:.4f} ms), {100 * bound_ms / ms:.1f}% of bound, "
              f"max abs err {err:.3e} ({worst[0]:.3f} of its bound)  "
              f"[{card}]")
        rows[("block_diag_matmul", label)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            err=err)

    y = torch.randn(n, PRECOND_WIDTH, generator=g, dtype=torch.float64,
                    device="cuda")
    a = torch.randn(PRECOND_WIDTH, generator=g, dtype=torch.float64,
                    device="cuda")
    for label, dt in (("f64", torch.float64), ("f32", torch.float32)):
        xb, yb, ab = x64.to(dt), y.to(dt), a.to(dt)
        worst = [0.0, ""]
        _b5_check(xb, yb, ab, -0.5, (True, True, True), f"timing {label}",
                  worst)
        rows[("fused_axpby_dots", label)] = _b5_timed(
            xb, yb, ab, -0.5, f"[timing] fused_axpby_dots {label}",
            PEAK_FLOPS[dt], 8.0, worst, card)
    return rows


def _b5_timed(x, y, a, b, label, peak, flops_per_entry, worst, card):
    """B5 at one shape with all three dots, a second call bit-equal:
    kernel (CUDA events over back-to-back calls), the same without dots, its device time a call
    from the profiler, host syncs a call, the plain version, and the bound
    (x and y read, y' written, the coefficients and the dots; operations
    at ``flops_per_entry`` over ``peak``).  ``worst`` holds the grid
    bound's ratio from :func:`_b5_check` or :func:`_b5_cx_check`.
    Returns the kernels line's row."""
    flags = dict(dot_yy=True, dot_xy=True, dot_xx=True)
    out, dots = fused_axpby_dots(x, y, a, b, **flags)
    _b5_same_twice(out, dots, x, y, a, b, (True, True, True), label)
    wide = torch.complex128 if out.is_complex() else torch.float64
    want, _ = fused_axpby_dots_ref(x.to(wide), y.to(wide),
                                   a.to(wide) if torch.is_tensor(a) else a,
                                   b, **flags)
    err = float((out.to(wide) - want).abs().max())
    ms = time_ms(lambda: fused_axpby_dots(x, y, a, b, **flags))
    nodots_ms = time_ms(lambda: fused_axpby_dots(x, y, a, b))
    dev_ms, syncs = None, None
    if DEVICE == "cuda":
        dev_ms, syncs = _b5_profile(lambda: fused_axpby_dots(x, y, a, b,
                                                             **flags))
    plain_ms = time_ms(lambda: fused_axpby_dots_ref(x, y, a, b, **flags),
                       warmup=3, iters=20)
    n, bw = x.shape
    nbytes = _nbytes(x, y, out, dots) + 2 * bw * dots.element_size()
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops_per_entry * n * bw / peak
    bound_ms = max(bytes_ms, ops_ms)
    dev_text = ("not measured (the profiler did not see one kernel a "
                "call)" if dev_ms is None
                else f"{dev_ms:.4f} ms ({100 * bound_ms / dev_ms:.1f}% of "
                f"bound)")
    sync_text = "not measured" if syncs is None else f"{syncs:.2f}"
    print(f"{label} n={n} bw={bw}, all three dots: kernel {ms:.4f} ms "
          f"({100 * bound_ms / ms:.1f}% of bound), without dots "
          f"{nodots_ms:.4f} ms, device time a call {dev_text}, host syncs "
          f"a call {sync_text}, plain {plain_ms:.4f} ms, library n/a (no "
          f"single PyTorch call computes it), bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e9:.1f} GB/s; "
          f"operations {ops_ms:.4f} ms), y' max abs err {err:.3e} (bounds: "
          f"{worst[0]:.3f} of the stated ones)  [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                err=err, device_ms=dev_ms, syncs=syncs, nodots_ms=nodots_ms)


def phase_pcg_split(pcg, card) -> None:
    """Where one full-width PCG iteration goes: B1 at b=4 with CG's flags
    and B4, each timed alone with CUDA events at the iteration's shapes,
    against the measured ms per iteration."""
    op, M, st = pcg["op"], pcg["M"], pcg["state"]
    opts = SpmvOpts(dot_xy=True)
    spmv_ms = time_ms(lambda: op.mv_fused(st.p, opts=opts))
    b4_ms = time_ms(lambda: M.apply(st.r))
    total = pcg["ms_iter"]
    rest = total - spmv_ms - b4_ms
    print(f"[pcg split] one iteration = {total:.3f} ms (anisotropic_laplace2d"
          f"({PRECOND_NX}) f64, b={PRECOND_WIDTH})  [{card}]")
    for name, ms in ((f"sellcs_spmv (b={PRECOND_WIDTH})", spmv_ms),
                     ("block_diag_matmul", b4_ms)):
        print(f"[pcg split]   {name:20s} 1 x {ms:.4f} ms "
              f"({100 * ms / total:.1f}%)")
    print(f"[pcg split]   {'rest':20s} {rest:.4f} ms ({100 * rest / total:.1f}"
          f"%): vector arithmetic (about ten passes over ({PRECOND_NX}^2, "
          f"{PRECOND_WIDTH}) vectors) and launches (phase 15b splits it)")
    print(f"[pcg split] time to solution: PCG {pcg['secs']:.3f} s "
          f"({pcg['iters']} iterations), plain CG {pcg['plain_secs']:.3f} s "
          f"({pcg['plain_iters']} iterations)")


# ---------------------------------------------------------------- phase 15b
#: iterations of each stepper comparison, and of its profiled window
STEP_ITERS = {"cg": 200, "cg_precond": 200, "block_cg": 40,
              "block_minres": 40}
STEP_PROFILED = {"cg": 50, "cg_precond": 50, "block_cg": 10,
                 "block_minres": 10}
#: steppers whose late-read iterations must make no synchronising call
NO_SYNC = ("block_cg", "block_minres")
#: kernel name fragments -> the category they are counted under (the
#: rest: cuBLAS/cuSOLVER kernels of the (b, b) algebra and small ops)
KERNEL_KINDS = (("sellcs_spmv", "B1 sellcs_spmv"),
                ("block_diag", "B4 block_diag"),
                ("tsmttsm", "B2 tsmttsm"), ("tsmm", "B3 tsmm"),
                ("herm_eig", "herm_eig"),
                ("Memcpy", "copies"), ("elementwise", "vector passes"),
                ("reduce", "vector passes"))


def _read_every_iteration(op, st, k, body, *args):
    """The stopping test read on the host before every iteration: what
    the late-read ``run_chunk`` is compared with."""
    i = 0
    while i < k and st.it < st.maxiter and not bool(st.done.all()):
        st = body(op, *args, st)
        i += 1
    return st


def _device_split(run, iters, kinds_of=KERNEL_KINDS):
    """``run()`` under ``torch.profiler`` (device activity only): per
    iteration, the device time of each kind of kernel (``kinds_of``) and
    of each kernel name, the time the card had no kernel running between
    the window's first and last kernel, and the wall time.  Returns None
    if the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    kinds, names = {}, {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = next((k for frag, k in kinds_of if frag in name), "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start)
        names[name] = names.get(name, 0.0) + (end - start)
        if start > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    ms = {k: v * 1e-3 / iters for k, v in kinds.items()}
    return dict(kinds=ms, names={k: v * 1e-3 / iters
                                 for k, v in names.items()},
                busy=busy * 1e-3 / iters, idle=(window - busy) * 1e-3 / iters,
                idle_share=(window - busy) / window,
                wall=1e3 * wall / iters)


def _syncs(run) -> int:
    """Synchronising CUDA calls ``run()`` makes (torch's sync debug
    mode; the late-read loop's event wait is not one of them).  The
    notice torch prints the first time the mode is set ("a prototype
    feature and does not yet detect all synchronizing operations") is no
    call and is not counted."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        run()
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def phase_stepper(fw, bcg, pcg, card) -> None:
    """The stopping test read one iteration late (``run_chunk``) against
    the loop that reads it before every iteration, at full width on the
    three main solver paths: equal states, ms per iteration in turns
    (every-iteration, late, late, every-iteration), host syncs per
    iteration, and the split of a late-read window by kind of kernel with
    the card's idle time."""
    A = fw["A64"]
    op64 = make_operator(A)
    b4 = A.permute(torch.from_numpy(
        np.random.default_rng(0).standard_normal((A.nrows, 4))))
    cases = [
        ("cg", "column CG f64 b=4", op64,
         cg_init(op64, b4, tol=1e-8, maxiter=3000), cg_mod._cg_body, ()),
        ("cg_precond", f"block-Jacobi PCG f64 b={PRECOND_WIDTH}", pcg["op"],
         cg_init(pcg["op"], pcg["b"], tol=PCG_TOL, maxiter=8 * pcg["A"].nrows,
                 M=pcg["M"]), cg_mod._cg_precond_body, (pcg["M"],)),
        ("block_cg", f"block CG f64 width {WIDTH}", bcg["op"],
         cg_init(bcg["op"], bcg["b"], tol=1e-8, maxiter=3000, block=True),
         block.block_cg_body, ()),
        ("block_minres", f"block MINRES f64 width {WIDTH}", bcg["op"],
         minres_init(bcg["op"], bcg["b"], tol=1e-6, maxiter=3000,
                     block=True), block.block_minres_body, ()),
    ]
    for name, label, op, st0, body, args in cases:
        k = STEP_ITERS[name]
        times = {"every": [], "late": []}
        outs = {}
        for kind in ("every", "late", "late", "every"):
            sync()
            t0 = time.perf_counter()
            if kind == "late":
                out = run_chunk(op, name, k, st0, body, *args)
            else:
                out = _read_every_iteration(op, st0, k, body, *args)
            sync()
            times[kind].append(1e3 * (time.perf_counter() - t0) / k)
            outs[kind] = out
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(outs["late"], outs["every"]))
        require(same and outs["late"].it == k,
                f"{label}: late-read states differ from every-iteration ones")
        print(f"[stepper] {label}, {k} iterations: ms/iter read every "
              f"iteration {' / '.join(f'{t:.3f}' for t in times['every'])},"
              f" read one late {' / '.join(f'{t:.3f}' for t in times['late'])}"
              f"; states bit-identical: {same}  [{card}]")
        if DEVICE != "cuda":
            continue
        syncs_late = _syncs(lambda: run_chunk(op, name, 3, st0, body, *args))
        syncs_every = _syncs(lambda: _read_every_iteration(op, st0, 3, body,
                                                           *args))
        print(f"[stepper] {label}: synchronising calls in 3 iterations "
              f"(torch's sync debug mode): read one late {syncs_late}, read "
              f"every iteration {syncs_every}")
        require(syncs_late == 0 or name not in NO_SYNC,
                f"{label}: {syncs_late} synchronising calls in 3 late-read "
                f"iterations")
        kp = STEP_PROFILED[name]
        split = _device_split(lambda: run_chunk(op, name, kp, st0, body, *args),
                              kp)
        if split is None:
            print(f"[stepper] {label}: the profiler saw no device kernels; "
                  f"split not measured")
            continue
        parts = ", ".join(f"{kind} {ms:.4f}" for kind, ms in
                          sorted(split["kinds"].items()))
        print(f"[stepper split] {label}, {kp} late-read iterations under the "
              f"profiler: {split['wall']:.3f} ms/iter wall; device ms/iter: "
              f"{parts}; card idle {split['idle']:.4f} ms/iter "
              f"({100 * split['idle_share']:.1f}% of the window)  [{card}]")


#: the coefficient hand-over's sync count (phase 15b): ChebFD's block
#: width and filter degree for one step, KPM's probes, and the window of
#: both on laplace3d(NX) (its spectrum lies inside (0, 12))
COEF_CHEB_B, COEF_KPM_PROBES, COEF_SPECTRUM = 8, 4, (0.0, 12.0)


def phase_coef_syncs(fw, card) -> dict:
    """Host syncs of the calls that hand a number or a tensor to a kernel
    as a coefficient, on laplace3d(NX) at the widths of phases 13 and 13c:
    B5 with Python-number ``a`` and ``b`` (float64) and with complex ones
    (complex128) at width PRECOND_WIDTH, B1 through ``ops`` with a
    Python-float gamma at ChebFD's block of COEF_CHEB_B, one step of
    ChebFD's filter (``chebfd._cheb_filter`` of degree 2: its first
    application and one step of the recurrence, two B1 launches, with the
    filter's vector passes) and one KPM moment step
    (``kpm.moment_step``, bf16-store/f32 operator as phase 10's KPM).
    Each call runs once first (the kernels load then), and its syncs are
    counted with torch's sync debug mode; every count must be 0.  On the
    CPU the calls run once and nothing is counted."""
    A64, A16 = fw["A64"], fw["A16"]
    n = A64.nrows_pad
    f64 = torch.float64
    g = torch.Generator(device=DEVICE).manual_seed(21)
    x4, y4 = (torch.randn(n, PRECOND_WIDTH, generator=g, dtype=f64,
                          device=DEVICE) for _ in range(2))
    xc, yc = (_cx_randn((n, PRECOND_WIDTH), torch.complex128, g)
              for _ in range(2))
    V = torch.randn(n, COEF_CHEB_B, generator=g, dtype=f64, device=DEVICE)
    lo, hi = COEF_SPECTRUM
    a, gam = (hi - lo) / 2.0, (hi + lo) / 2.0
    op64, op16 = make_operator(A64), make_operator(A16)
    w0 = torch.randn(n, COEF_KPM_PROBES, generator=g, dtype=torch.float32,
                     device=DEVICE)
    w1 = torch.randn(n, COEF_KPM_PROBES, generator=g, dtype=torch.float32,
                     device=DEVICE)
    mu = torch.ones(COEF_KPM_PROBES, dtype=torch.float32, device=DEVICE)
    dots = dict(dot_yy=True, dot_xy=True, dot_xx=True)
    calls = [
        ("B5 f64, Python-number a and b",
         lambda: fused_axpby_dots(x4, y4, 0.75, -0.5, **dots)),
        ("B5 complex128, complex a and b",
         lambda: fused_axpby_dots(xc, yc, 0.5 - 1.5j, -1.0 + 0.25j, **dots)),
        (f"B1 through ops, Python-float gamma, b={COEF_CHEB_B}",
         lambda: sellcs_spmv(A64, V, opts=SpmvOpts(alpha=1.0 / a,
                                                   gamma=gam))),
        (f"one ChebFD filter step, b={COEF_CHEB_B}",
         lambda: chebfd_mod._cheb_filter(op64, V, 2, a, gam, 1.0, 2.0)),
        (f"one KPM moment step, {COEF_KPM_PROBES} probes",
         lambda: kpm_mod.moment_step(op16, w0, w1, 2.0 / a, gam, mu, mu)),
    ]
    counts = {}
    for label, fn in calls:
        fn()
        sync()
        if DEVICE != "cuda":
            continue
        counts[label] = _syncs(fn)
        sync()
        print(f"[coef syncs] {label}: {counts[label]} host syncs a call "
              f"(torch's sync debug mode)  [{card}]")
    for label, k in counts.items():
        require(k == 0, f"{label}: {k} host syncs a call")
    return counts


def _b5_profile(fn, iters: int = 20):
    """B5's device time a call (``torch.profiler`` over ``iters``
    back-to-back calls, the kernels whose name holds ``axpby``; None
    unless the profiler saw one such kernel a call: a window that lost
    events once gave half the time) and host syncs a call (torch's sync
    debug mode)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "axpby" in e.name]
    dev = 1e-3 * sum(spans) / iters if len(spans) == iters else None
    return dev, _syncs(lambda: [fn() for _ in range(iters)]) / iters


# ---------------------------------------------------------------- phase 15c
#: slice 6: the serving phase.  Mixed traffic on laplace3d(NX) (the tols
#: cycle, every fourth request MINRES), the SLO traffic (stragglers on
#: anisotropic_laplace2d(PRECOND_NX) first, then easy requests), block
#: requests in two waves, block-Jacobi requests on
#: anisotropic_laplace2d(SERVE_PRECOND_NX), and the card-against-CPU
#: scenario on laplace3d(SERVE_VC_NX) under a virtual clock
SERVE_REQUESTS, SERVE_WIDTH, SERVE_CHUNK = 32, 8, 16
SERVE_TOLS, SERVE_MAXITER = (1e-5, 1e-6, 1e-7), 3000
SLO_HARD, SLO_HARD_TOL, SLO_HARD_MAXITER = 4, 1e-12, 600
SLO_EASY, SLO_EASY_TOL, SLO_EASY_MAXITER = 24, 1e-4, 300
SERVE_BLOCK, SERVE_BLOCK_TOL = 8, 1e-6
SERVE_PRECOND_NX, SERVE_PRECOND, SERVE_PRECOND_TOL = 1024, 8, 1e-8
SERVE_VC_NX = 12
#: est_iter_s (the service's EWMA) against the measured seconds per
#: iteration of the same chunks
SERVE_EST_SLACK = 0.25


class VirtualClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _pct(vals, q) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _serve_residuals(reg, tickets, label) -> float:
    """True relative residual ``||b - A x|| / ||b||`` of every converged
    ticket, on the card in original space through the plain SpMV, each at
    most 10 tol; returns the largest ratio to its tol."""
    worst = 0.0
    conv = [t for t in tickets if t.result is not None and t.result.converged]
    for name in sorted({t.matrix for t in conv}):
        A = reg.entry(name).matrix
        mine = [t for t in conv if t.matrix == name]
        for i in range(0, len(mine), SERVE_WIDTH):
            group = mine[i:i + SERVE_WIDTH]
            X = torch.from_numpy(np.stack([t.result.x for t in group], 1))
            B = torch.from_numpy(np.stack([t.b for t in group], 1))
            B = B.to(device=DEVICE, dtype=A.dtype)
            Ax, _, _ = sellcs_spmv_ref(A, A.permute(X.to(DEVICE)))
            rel = (B - A.unpermute(Ax)).norm(dim=0) / B.norm(dim=0)
            for t, r in zip(group, rel.tolist()):
                require(r <= 10 * t.tol, f"{label}: ticket #{t.id} true "
                        f"residual {r:.3e} > 10 tol = {10 * t.tol:.0e}")
                worst = max(worst, r / t.tol)
    return worst


def _serve_gates(svc, reg, tickets, label, kernels=("sellcs_spmv",)):
    """The gates of every serving leg: one terminal transition a ticket,
    the stats partition, the true residual of every converged request
    and a launch of each named kernel.  Returns the launch counts."""
    launches = execution.launch_counts()
    require(svc.pending == 0, f"{label}: {svc.pending} requests pending")
    for t in tickets:
        require(t._terminal_transitions == 1 and t.status in TERMINAL_STATES,
                f"{label}: {t!r} took {t._terminal_transitions} terminal "
                f"transitions")
    s = svc.stats
    require(s["submitted"] == s["retired"] + s["cancelled"] + s["expired"]
            + s["rejected"], f"{label}: stats do not partition: {s}")
    worst = _serve_residuals(reg, tickets, label)
    got = {k: launches.get(k, 0) for k in kernels}
    for k in kernels:
        require(got[k] > 0 or DEVICE == "cpu", f"{label}: {k} not launched")
    conv = sum(t.result is not None and t.result.converged for t in tickets)
    print(f"[serve] {label}: {conv} of {len(tickets)} converged, largest "
          f"true residual {worst:.2f} tol; launches {got}; stats {s}")
    return got


def _serve_mixed_requests(n):
    rng = np.random.default_rng(7)
    return [("minres" if i % 4 == 3 else "cg", rng.standard_normal(n),
             SERVE_TOLS[i % len(SERVE_TOLS)])
            for i in range(SERVE_REQUESTS)]


def _serve_baseline(op, reqs):
    """One monolithic ``cg``/``minres`` call per request, arriving at
    t = 0 and answered in turn; returns latencies and solutions."""
    solvers = {"cg": cg, "minres": minres}
    lat, xs = [], []
    sync()
    t0 = time.perf_counter()
    for solver, b, tol in reqs:
        res = solvers[solver](op, op.to_op_space(torch.from_numpy(b)),
                              tol=tol, maxiter=SERVE_MAXITER)
        xs.append(op.from_op_space(res.x).cpu().numpy())
        lat.append(time.perf_counter() - t0)
        require(bool(res.converged), f"baseline {solver} tol {tol}: not "
                f"converged")
    return lat, xs


def _serve_drain(svc, matrix, reqs, **kw):
    """Submit every request at t = 0 and drain; returns tickets, wall."""
    sync()
    t0 = time.perf_counter()
    tickets = [svc.submit(matrix, b, solver=solver, tol=tol,
                          maxiter=SERVE_MAXITER, **kw)
               for solver, b, tol in reqs]
    svc.drain()
    sync()
    return tickets, time.perf_counter() - t0


def _latency_line(lat) -> str:
    return (f"p50 {1e3 * _pct(lat, 50):.1f} ms, p99 {1e3 * _pct(lat, 99):.1f}"
            f" ms")


class DrainSplit:
    """Exclusive seconds of a drain by part.  Each wrapped call
    synchronises the card before and after it, and the time of the calls
    nested in it is theirs, not its own.  The ``done`` flags a chunk reads
    count to the chunk."""

    PARTS = ("chunk", "refill", "upload", "init", "merge", "retire",
             "finalize", "download")

    def __init__(self, svc):
        self.secs = dict.fromkeys(self.PARTS, 0.0)
        self.stack = []
        self.chunks = {}          # batch key -> [secs, iterations, est]
        for part, name in (("chunk", "_run_chunk"), ("refill", "_refill"),
                           ("refill", "_refill_block"),
                           ("retire", "_retire_and_refill"),
                           ("upload", "_upload"),
                           ("download", "_download")):
            setattr(svc, name, self.wrap(part, getattr(svc, name)))
        refill = svc._refill
        svc._refill = lambda batch: refill(self.batch(batch))

    def batch(self, batch):
        """Wrap a batch's init, merge and finalize once."""
        if not getattr(batch, "split_wrapped", False):
            batch.init = self.wrap("init", batch.init)
            batch.merge = self.wrap("merge", batch.merge)
            batch.finalize = self.wrap("finalize", batch.finalize)
            batch.split_wrapped = True
        return batch

    def wrap(self, part, fn):
        def timed_call(*args):
            sync()
            t0 = time.perf_counter()
            own = "chunk" if part == "download" and self.stack and \
                self.stack[-1][0] == "chunk" else part
            self.stack.append([own, 0.0])
            it0 = (args[0].state.it if part == "chunk"
                   and args[0].state is not None else None)
            out = fn(*args)
            sync()
            dt = time.perf_counter() - t0
            _, child = self.stack.pop()
            self.secs[own] += dt - child
            if self.stack:
                self.stack[-1][1] += dt
            if it0 is not None:
                batch = args[0]
                rec = self.chunks.setdefault(batch.key, [0.0, 0, None, 0])
                rec[0] += dt - child
                rec[1] += batch.state.it - it0
                rec[2] = batch.est_iter_s
                rec[3] += 1
            return out
        return timed_call


def _serve_vc_scenario(device):
    """The virtual-clock scenario of the card-against-CPU check: mixed
    tolerances and solvers, a deadline that expires while running, a
    cancel while running, and block requests that warm-restart."""
    r, c, v, n = laplace3d(SERVE_VC_NX)
    reg = MatrixRegistry()
    reg.register("m", rows=r, cols=c, vals=v, shape=(n, n), C=32, sigma=64,
                 dtype=np.float64, device=device)
    clock = VirtualClock()
    svc = SolverService(reg, block_width=4, chunk_iters=8, clock=clock)
    rng = np.random.default_rng(3)
    tols = (1e-6, 1e-8, 1e-10)
    ts = [svc.submit("m", rng.standard_normal(n), tol=tols[i % 3],
                     solver="minres" if i % 3 == 2 else "cg")
          for i in range(7)]
    ts.append(svc.submit("m", rng.standard_normal(n), tol=1e-30,
                         maxiter=10 ** 6, deadline=3.0))
    ts += [svc.submit("m", rng.standard_normal(n), tol=1e-8, block=True)
           for _ in range(2)]
    svc.step()
    clock.now += 1.0
    ts += [svc.submit("m", rng.standard_normal(n), tol=1e-8, block=True)
           for _ in range(2)]
    svc.cancel(ts[1])
    while svc.pending:
        svc.step()
        clock.now += 1.0
    return ts, svc.stats


def phase_serving(fw, pcg, card) -> None:
    """Slice 6's main path: the continuous-batching SolverService over the
    registry at full width, against one solve per request; the SLO
    traffic under FIFO and bucketed admission; block and block-Jacobi
    requests; the card against the CPU under a virtual clock; and where a
    drain's time goes."""
    A = fw["A64"]
    n = A.nrows
    reg = MatrixRegistry()
    reg.register("lap", A)
    reg.register("ani", pcg["A"])
    op = reg.operator("lap")
    print(f"[serve] registered laplace3d n={n} and anisotropic_laplace2d "
          f"n={pcg['A'].nrows} (prebuilt, f64); keys carry "
          f"{reg.entry('lap').store_dtype!r}")

    # (1) mixed traffic against one solve per request
    reqs = _serve_mixed_requests(n)
    base_lat, base_x = _serve_baseline(op, reqs)
    base_wall = base_lat[-1]
    svc = SolverService(reg, block_width=SERVE_WIDTH,
                        chunk_iters=SERVE_CHUNK, admission="fifo")
    execution.reset_launch_counts()
    tickets, wall = _serve_drain(svc, "lap", reqs)
    _serve_gates(svc, reg, tickets, "mixed traffic")
    require(all(t.status == "done" and t.result.converged for t in tickets),
            "mixed traffic: a request did not converge")
    lat = [t.latency for t in tickets]
    print(f"[serve] mixed traffic, {len(reqs)} requests (f64, width "
          f"{SERVE_WIDTH}, chunk {SERVE_CHUNK}, fifo): baseline "
          f"{len(reqs) / base_wall:.3f} requests/s ({base_wall:.3f} s; "
          f"{_latency_line(base_lat)}); service {len(reqs) / wall:.3f} "
          f"requests/s ({wall:.3f} s; {_latency_line(lat)}; "
          f"{svc.stats['chunks']} chunks, {svc.stats['refills']} refills); "
          f"service {base_wall / wall:.2f}x the baseline  [{card}]")
    # one service request against the standalone cg of the same rhs: the
    # two runs reduce at different widths, so 100 tol (the JAX package's
    # own margin: atol 1e-5 at tol 1e-7)
    i = next(i for i, (s, _, tol) in enumerate(reqs)
             if s == "cg" and tol == min(SERVE_TOLS))
    xb = base_x[i]
    agree = np.abs(tickets[i].result.x - xb).max() / np.abs(xb).max()
    print(f"[serve] request #{i} (cg, tol {reqs[i][2]}) against its "
          f"standalone cg: max difference {agree:.2e} of max|x|")
    require(agree <= 100 * reqs[i][2],
            f"service request differs from cg by {agree:.2e}")

    # (2) SLO traffic: stragglers first, FIFO against bucketed admission
    rng = np.random.default_rng(11)
    hard = [rng.standard_normal(pcg["A"].nrows) for _ in range(SLO_HARD)]
    easy = [rng.standard_normal(n) for _ in range(SLO_EASY)]
    for name in ("lap", "ani"):
        reg.predicted_iters(name)          # the Lanczos run, before timing
    slo = {}
    for admission in ("fifo", "bucketed"):
        svc = SolverService(reg, block_width=SERVE_WIDTH,
                            chunk_iters=SERVE_CHUNK, admission=admission,
                            adaptive_width=False)
        execution.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        ts = [("hard", svc.submit("ani", b, tol=SLO_HARD_TOL,
                                  maxiter=SLO_HARD_MAXITER)) for b in hard]
        ts += [("easy", svc.submit("lap", b, tol=SLO_EASY_TOL,
                                   maxiter=SLO_EASY_MAXITER)) for b in easy]
        svc.drain()
        sync()
        wall = time.perf_counter() - t0
        _serve_gates(svc, reg, [t for _, t in ts], f"SLO {admission}")
        require(all(t.status == "done" for _, t in ts),
                f"SLO {admission}: a request was lost")
        lat = {c: [t.latency for k, t in ts if k == c]
               for c in ("easy", "hard")}
        slo[admission] = (lat, wall)
        keys = sorted({t.key[6] or "-" for _, t in ts})
        print(f"[serve] SLO {admission}: {SLO_HARD} stragglers (tol "
              f"{SLO_HARD_TOL}, maxiter {SLO_HARD_MAXITER}) then {SLO_EASY} "
              f"easy (tol {SLO_EASY_TOL}, maxiter {SLO_EASY_MAXITER}), "
              f"buckets {keys}: drain {wall:.3f} s; easy "
              f"{_latency_line(lat['easy'])}; stragglers "
              f"{_latency_line(lat['hard'])}  [{card}]")
    (f_lat, f_wall), (b_lat, b_wall) = slo["fifo"], slo["bucketed"]
    print(f"[serve] SLO: easy p99 {_pct(f_lat['easy'], 99) / _pct(b_lat['easy'], 99):.2f}x "
          f"better under bucketed admission; drain time bucketed / fifo "
          f"{b_wall / f_wall:.3f}  [{card}]")

    # (3) block requests in two waves (one warm restart), then
    # block-Jacobi requests
    svc = SolverService(reg, block_width=SERVE_WIDTH, chunk_iters=SERVE_CHUNK)
    execution.reset_launch_counts()
    rng = np.random.default_rng(13)
    ts = [svc.submit("lap", rng.standard_normal(n), tol=SERVE_BLOCK_TOL,
                     maxiter=SERVE_MAXITER, block=True)
          for _ in range(SERVE_BLOCK // 2)]
    sync()
    t0 = time.perf_counter()
    svc.step()
    ts += [svc.submit("lap", rng.standard_normal(n), tol=SERVE_BLOCK_TOL,
                      maxiter=SERVE_MAXITER, block=True)
           for _ in range(SERVE_BLOCK - SERVE_BLOCK // 2)]
    svc.drain()
    sync()
    wall = time.perf_counter() - t0
    _serve_gates(svc, reg, ts, "block requests", BLOCK_KERNELS)
    require(svc.stats["refills"] >= 2, "block requests: no warm restart")
    require(all(t.result.converged for t in ts),
            "block requests: not converged")
    print(f"[serve] {SERVE_BLOCK} block CG requests in two waves: {wall:.3f}"
          f" s, {svc.stats['refills'] - 1} warm restart(s), iterations "
          f"{sorted(t.result.iters for t in ts)}  [{card}]")

    Ap = _aniso(SERVE_PRECOND_NX)
    reg.register("ani_pc", Ap)
    t0 = time.perf_counter()
    reg.preconditioner("ani_pc", "block_jacobi:32")
    sync()
    setup = time.perf_counter() - t0
    svc = SolverService(reg, block_width=SERVE_WIDTH, chunk_iters=SERVE_CHUNK)
    execution.reset_launch_counts()
    rng = np.random.default_rng(17)
    sync()
    t0 = time.perf_counter()
    ts = [svc.submit("ani_pc", rng.standard_normal(Ap.nrows),
                     tol=SERVE_PRECOND_TOL, maxiter=8 * Ap.nrows,
                     precond="block_jacobi:32")
          for _ in range(SERVE_PRECOND)]
    svc.drain()
    sync()
    wall = time.perf_counter() - t0
    _serve_gates(svc, reg, ts, "block-Jacobi requests", PRECOND_KERNELS)
    require(all(t.result.converged for t in ts),
            "block-Jacobi requests: not converged")
    print(f"[serve] {SERVE_PRECOND} block_jacobi:32 CG requests on "
          f"anisotropic_laplace2d({SERVE_PRECOND_NX}): registry set-up "
          f"{setup:.2f} s (host), drain {wall:.3f} s, iterations "
          f"{sorted(t.result.iters for t in ts)}  [{card}]")

    # (4) the card against the CPU under a virtual clock
    got, got_stats = _serve_vc_scenario(DEVICE)
    want, want_stats = _serve_vc_scenario("cpu")
    require(got_stats == want_stats,
            f"virtual clock: stats {got_stats} != CPU {want_stats}")
    worst = 0.0
    for g, w in zip(got, want):
        same = (g.status, g.latency, g.queue_wait, g.key) == \
            (w.status, w.latency, w.queue_wait, w.key)
        require(same and (g.result is None) == (w.result is None),
                f"virtual clock: {g!r} != CPU {w!r}")
        if w.result is None:
            continue
        require((g.result.iters, g.result.converged)
                == (w.result.iters, w.result.converged),
                f"virtual clock: {g!r} iterations {g.result.iters} != CPU "
                f"{w.result.iters}")
        err = np.abs(g.result.x - w.result.x).max() / np.abs(w.result.x).max()
        worst = max(worst, err)
    require(worst <= 1e-9, f"virtual clock: x differs from the CPU's by "
            f"{worst:.2e}")
    print(f"[serve] laplace3d({SERVE_VC_NX}) under a virtual clock, card "
          f"against CPU: statuses {sorted(t.status for t in got)}, equal "
          f"iterations, latencies and stats ({got_stats}); x within "
          f"{worst:.2e} of max|x|")

    # (5) where a drain's time goes: the mixed traffic again, each part
    # synchronised
    svc = SolverService(reg, block_width=SERVE_WIDTH,
                        chunk_iters=SERVE_CHUNK, admission="fifo")
    split = DrainSplit(svc)
    tickets, wall = _serve_drain(svc, "lap", reqs)
    require(all(t.result.converged for t in tickets),
            "drain split: a request did not converge")
    parts = ", ".join(f"{p} {s:.3f} s ({100 * s / wall:.1f}%)"
                      for p, s in split.secs.items())
    other = wall - sum(split.secs.values())
    print(f"[serve split] mixed traffic drain {wall:.3f} s: {parts}, other "
          f"{other:.3f} s ({100 * other / wall:.1f}%)  [{card}]")
    for key, (secs, iters, est, nchunks) in split.chunks.items():
        ms = 1e3 * secs / max(iters, 1)
        est_ms = 1e3 * (est or 0.0)
        print(f"[serve split] batch {key[1]}: {nchunks} chunks, {iters} "
              f"iterations, measured {ms:.4f} ms/iter, the service's EWMA "
              f"est_iter_s {est_ms:.4f} ms/iter ({est_ms / ms:.3f}x)")
        require(DEVICE == "cpu" or abs(est_ms - ms) <= SERVE_EST_SLACK * ms,
                f"est_iter_s {est_ms:.4f} ms is not within "
                f"{SERVE_EST_SLACK:.0%} of the measured {ms:.4f} ms/iter")
    # a refill's upload as the JAX package makes it (the whole (n, w) host
    # block, one copy) against the service's (the admitted columns, one
    # contiguous copy each): best of 3, equal blocks
    for m in (1, 3, SERVE_WIDTH):
        cols = [(j, reqs[j][1]) for j in range(m)]
        best, outs = {}, {}
        for name, fn in (("jax", _reference_upload), ("svc", svc._upload)):
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                outs[name] = fn(op, n, SERVE_WIDTH, cols)
                sync()
                best[name] = min(best.get(name, np.inf),
                                 time.perf_counter() - t0)
        require(torch.equal(outs["jax"], outs["svc"]),
                "the service's upload differs from the full block's")
        print(f"[serve split] refill upload of {m} column(s) into a "
              f"({n}, {SERVE_WIDTH}) f64 block: the JAX package's full "
              f"host block {1e3 * best['jax']:.1f} ms, the service's "
              f"admitted columns {1e3 * best['svc']:.1f} ms (equal "
              f"blocks)  [{card}]")


def _reference_upload(op, n, w, cols):
    """A refill's upload as the JAX package makes it: the whole ``(n, w)``
    block on the host, each admitted column copied in, one upload and
    one permute."""
    Bg = np.zeros((n, w))
    for j, b in cols:
        Bg[:, j] = b
    return op.to_op_space(torch.from_numpy(Bg).to(DEVICE))


# ---------------------------------------------------------- phases 15d-15h
#: slice 7: the heterogeneous engine.  Card shards run on DEVICE (a CPU
#: rehearsal puts every shard on the host); the paper's workload comes
#: from ``configs/ghost_spmv.py``; CG, the rebalance loop and serving run
#: on laplace3d(NX), phase 6's matrix
MLGEER, ENGINE_SHARDS, ENGINE_TOL = "mlgeer_like", 4, 1e-8
REBALANCE_STEPS, REBALANCE_CALLS = 3, 10
ENGINE_SERVE_REQUESTS, ENGINE_SERVE_PRECOND = 6, "chebyshev:3"
#: the copies that measure the pool's bandwidths: bytes of the source
BW_BYTES, PIN_BYTES = 2 << 30, 1 << 30
#: a distributed matvec against the one-device B1 SpMV: max |dy| / max |y|
DIST_TOL = 1e-12


def wall_ms(fn, warmup: int = 3, iters: int = 20, wait=None) -> float:
    """Host clock around ``iters`` calls that end in a synchronise (``wait``,
    default ``sync``): the time of work shared between the card and the
    host, or between cards (``wait=sync_cards``)."""
    wait = wait or sync
    for _ in range(warmup):
        fn()
    wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wait()
    return 1e3 * (time.perf_counter() - t0) / iters


def sync_cards() -> None:
    """Wait for every card (``sync`` waits for the current one only)."""
    if DEVICE == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def host_cpu() -> str:
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``), with
    the machine type and the cores the process may use."""
    text = Path("/proc/cpuinfo").read_text()
    if shutil.which("lscpu"):
        text += subprocess.run(["lscpu"], capture_output=True, text=True,
                               check=False).stdout
    names = [line.split(":", 1)[1].strip() for line in text.splitlines()
             if line.lower().startswith(("model name", "vendor_id",
                                         "vendor id"))]
    named = [m for m in names if m.lower() not in ("", "-", "unknown")]
    name = " / ".join(dict.fromkeys(named)) or "model not named"
    return f"{name} ({platform.machine()}, {len(os.sched_getaffinity(0))} cores)"


def _card_launches(A) -> int:
    """B1 launches of one distributed matvec: every card shard's local
    part, and its remote part where that holds nonzeros."""
    if DEVICE == "cpu":
        return 0
    return sum(1 + (s.remote.nnz > 0) for s in A.shards
               if s.device.type == "cuda")


def _split_line(A) -> str:
    return ", ".join(f"{s.device} {e - b} rows/{nnz} nnz/halo {s.nhalo}"
                     for s, (b, e), nnz in zip(A.shards, A.row_ranges,
                                               A.shard_nnz))


# ---------------------------------------------------------------- phase 15d
def phase_bandwidths(card):
    """The memory rates of the device pool's table (``KNOWN_DEVICE_SPECS``
    in ``runtime/devicepool.py``): a float64 copy on the card and one on
    the host, each counted as read + write bytes, and pinned copies from
    the host to the card and back (one-way bytes)."""
    cpu = host_cpu()
    n = BW_BYTES // 8
    src = torch.ones(n, dtype=torch.float64, device="cuda")
    dst = torch.empty_like(src)
    dev_bw = 2 * BW_BYTES / (time_ms(lambda: dst.copy_(src), 3, 10) * 1e-3)
    del src, dst
    src = torch.ones(n, dtype=torch.float64)
    dst = torch.empty_like(src)
    best = np.inf
    for _ in range(6):
        t0 = time.perf_counter()
        dst.copy_(src)
        best = min(best, time.perf_counter() - t0)
    host_bw = 2 * BW_BYTES / best
    del src, dst
    pinned = torch.ones(PIN_BYTES // 8, dtype=torch.float64,
                        pin_memory=True)
    dev = torch.empty(PIN_BYTES // 8, dtype=torch.float64, device="cuda")
    h2d = PIN_BYTES / (time_ms(lambda: dev.copy_(pinned, non_blocking=True),
                               2, 10) * 1e-3)
    d2h = PIN_BYTES / (time_ms(lambda: pinned.copy_(dev, non_blocking=True),
                               2, 10) * 1e-3)
    del pinned, dev
    p2p = None
    if torch.cuda.device_count() >= 2:
        src = torch.ones(n, dtype=torch.float64, device="cuda:0")
        dst = torch.empty(n, dtype=torch.float64, device="cuda:1")
        with torch.cuda.device(0):
            p2p = BW_BYTES / (time_ms(lambda: dst.copy_(src), 2, 10) * 1e-3)
        del src, dst
    print(f"[bandwidth] card copy {dev_bw / 1e9:.1f} GB/s ({2 * BW_BYTES >> 30}"
          f" GiB read + written); host copy {host_bw / 1e9:.1f} GB/s "
          f"({torch.get_num_threads()} threads, best of 6); pinned host->card"
          f" {h2d / 1e9:.1f} GB/s, card->host {d2h / 1e9:.1f} GB/s "
          f"({PIN_BYTES >> 30} GiB); cuda:0->cuda:1 "
          + ("not measured (one card)" if p2p is None else
             f"{p2p / 1e9:.1f} GB/s ({BW_BYTES >> 30} GiB)")
          + f"  [{card}; host {cpu}; {torch.cuda.device_count()} card(s)]")
    return dict(card=dev_bw, host=host_bw, h2d=h2d, d2h=d2h, p2p=p2p,
                cpu=cpu)


# ---------------------------------------------------------------- phase 15e
def phase_mlgeer(card):
    """The paper's workload (ML_Geer-like, f64, b = 4): the distributed
    SpMV on one card shard, on ENGINE_SHARDS card shards and on the host
    plus the card (the pool's modeled weights), each against the
    one-device plain SpMV (as is the one-device B1), with overlap and
    without, the double-buffered chain, B1's launches and where the time
    goes."""
    wl = WORKLOADS[MLGEER]
    t0 = time.perf_counter()
    r, c, v, n = banded_random(wl.n, bw=wl.bw, density=wl.density, seed=0)
    print(f"[mlgeer] {MLGEER}: n={n} nnz={len(v)} (band {wl.bw}, density "
          f"{wl.density}), b={wl.nvecs}, f64, C={wl.C} sigma={wl.sigma} "
          f"w_align={wl.w_align}: generated in "
          f"{time.perf_counter() - t0:.1f} s")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n, wl.nvecs)))
    kw = dict(C=wl.C, sigma=wl.sigma, w_align=wl.w_align, dtype=np.float64)
    splits = (("1 card shard", [DEVICE]),
              (f"{ENGINE_SHARDS} card shards", [DEVICE] * ENGINE_SHARDS),
              ("cpu + card", [DEVICE, "cpu"]))
    out = {"launches": 0, "ms": {}}
    y_ref = None
    for label, devs in splits:
        t0 = time.perf_counter()
        eng = HeterogeneousEngine(r, c, v, n, devices=devs, **kw)
        sync()
        build_s = time.perf_counter() - t0
        A = eng.A
        if y_ref is None:
            # one shard's local part is the one-device matrix: from_coo
            # over every row with the same C, sigma and w_align.  The
            # reference is its plain SpMV; the one-device B1 is held
            # against it as every split is
            A1 = A.shards[0].local
            xp = A1.permute(x.to(DEVICE))
            y_ref = A1.unpermute(sellcs_spmv_ref(A1, xp)[0])
            err1 = rel_err(A1.unpermute(sellcs_spmv(A1, xp)[0]), y_ref)
            require(err1 <= DIST_TOL, f"mlgeer: one-device B1 {err1:.3e} of "
                    f"max|y| off its plain version")
            one_ms = wall_ms(lambda: sellcs_spmv(A1, xp))
            out["one_ms"] = one_ms
            print(f"[mlgeer] one-device B1 SpMV: {one_ms:.4f} ms "
                  f"(cap {A1.cap}, beta {A1.beta:.4f}); max|dy| {err1:.2e} "
                  f"of max|y| against the plain SpMV  [{card}]")
            out["w_align"] = _w_align_timing(r, c, v, n, x, A1, xp, y_ref,
                                             wl, card)
        execution.reset_launch_counts()
        y_ov, _ = eng.spmv(x, overlap=True)
        sync()
        got = execution.launch_counts().get(KERNEL, 0)
        require(got == _card_launches(A), f"mlgeer {label}: {got} B1 "
                f"launches, expected {_card_launches(A)}")
        out["launches"] += got
        y_no, _ = eng.spmv(x, overlap=False)
        err = rel_err(y_ov, y_ref)
        require(err <= DIST_TOL, f"mlgeer {label}: {err:.3e} of max|y| off "
                f"the plain one-device SpMV")
        same = torch.equal(y_ov, y_no)
        require(same or "cpu" in devs, f"mlgeer {label}: overlap changed bits")
        xs = A.distribute_vec(x)
        run_db = eng.make_matvec(nvecs=wl.nvecs, double_buffer=True)
        run_nb = eng.make_matvec(nvecs=wl.nvecs)
        w, stg = xs, None
        for _ in range(3):
            w, _, stg = run_db(w, staging=stg)
        w2 = xs
        for _ in range(3):
            w2, _, _ = run_nb(w2)
        same_db = all(torch.equal(a, b) for a, b in zip(w, w2))
        require(same_db, f"mlgeer {label}: double-buffered chain differs")
        ms = {ov: wall_ms(lambda: eng.make_matvec(nvecs=wl.nvecs,
                                                  overlap=ov)(xs))
              for ov in (True, False)}
        out["ms"][label] = ms
        print(f"[mlgeer] {label}: build {build_s:.1f} s; {_split_line(A)}; "
              f"halo words comm_volume {A.comm_volume} (max_msg "
              f"{A.max_msg}, h_max {A.h_max}); max|dy| {err:.2e} of max|y|;"
              f" overlap == no overlap bit for bit: {same}; double-buffered"
              f" chain == unbuffered: {same_db}; B1 launches {got}; "
              f"{ms[True]:.4f} ms/matvec with overlap, {ms[False]:.4f} "
              f"without ({ms[True] / one_ms:.2f}x the one-device SpMV)  "
              f"[{card}]")
        if len(devs) == ENGINE_SHARDS and DEVICE == "cuda":
            out["remote"] = _remote_timing(A, wl.nvecs, card)
            out["stages"] = _stage_split(A, xs, card)
            out["profile"] = _matvec_profile(eng, xs, wl.nvecs, card)
        if "cpu" in devs:
            out["host_split"] = _host_split(eng, x, wl.nvecs, card)
        if (label == f"{ENGINE_SHARDS} card shards"
                and len(_cross_devices()) >= 2):
            # phase 15i moves these shards onto the cards
            out["keep"] = dict(eng=eng, x=x, y_ref=y_ref, coo=(r, c, v, n),
                               kw=kw)
        del eng, A, xs, w, w2, stg
    return out


def _w_align_timing(r, c, v, n, x, A1, xp, y_ref, wl, card):
    """The one-device B1 SpMV at the JAX package's chunk-width rounding
    (w_align 8, for its kernel's width tiling) beside the workload's,
    timed in turns, and held against the plain reference."""
    A8 = from_coo(r, c, v, (n, n), C=wl.C, sigma=wl.sigma, w_align=8,
                  dtype=np.float64, device=DEVICE)
    x8 = A8.permute(x.to(DEVICE))
    err = rel_err(A8.unpermute(sellcs_spmv(A8, x8)[0]), y_ref)
    require(err <= DIST_TOL, f"mlgeer w_align 8: B1 {err:.3e} of max|y| off")
    ms = {"own": [], "8": []}
    for _ in range(2):
        ms["own"].append(wall_ms(lambda: sellcs_spmv(A1, xp)))
        ms["8"].append(wall_ms(lambda: sellcs_spmv(A8, x8)))
    print(f"[mlgeer] one-device B1 SpMV by chunk-width rounding, in turns: "
          f"w_align {wl.w_align} {ms['own'][0]:.4f} / {ms['own'][1]:.4f} ms "
          f"(cap {A1.cap}), w_align 8 {ms['8'][0]:.4f} / {ms['8'][1]:.4f} ms"
          f" (cap {A8.cap}, max|dy| {err:.2e} of max|y|)  [{card}]")
    return ms


def _remote_timing(A, b, card):
    """B1 on an interior shard's remote part (rectangular: x is the halo,
    y_in the local result) against its plain version and its bytes
    bound."""
    p = min(1, A.nshards - 1)
    R = A.shards[p].remote
    g = torch.Generator(device="cuda").manual_seed(4)
    halo = torch.randn(x_rows(R), b, dtype=R.dtype, device="cuda",
                       generator=g)
    y_in = torch.randn(R.nrows_pad, b, dtype=R.dtype, device="cuda",
                       generator=g)
    opts = SpmvOpts(beta=1.0)
    yk, _, _ = sellcs_spmv(R, halo, y_in, opts=opts)
    yr, _, _ = sellcs_spmv_ref(R, halo, y_in, opts=opts)
    err = rel_err(yk, yr)
    require(err <= TOL[torch.float64]["vec"], f"remote part: kernel vs "
            f"plain {err:.3e}")
    ms = time_ms(lambda: sellcs_spmv(R, halo, y_in, opts=opts))
    plain_ms = time_ms(lambda: sellcs_spmv_ref(R, halo, y_in, opts=opts),
                       3, 20)
    # back-to-back calls as small as this one may be bound by the host's
    # launch of each call: the profiler's device time of the kernel alone
    dev = _device_split(lambda: [sellcs_spmv(R, halo, y_in, opts=opts)
                                 for _ in range(100)], 100)
    dev_ms = None if dev is None else dev["kinds"].get("B1 sellcs_spmv")
    nbytes, stored = _spmv_bytes(R, halo, yk, y_in), _stored_bytes(R)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[mlgeer] shard {p}'s remote part ({R.nrows} x {R.ncols}, nnz "
          f"{R.nnz}, cap {R.cap}): B1 {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB needed: the "
          f"nonzeros, the halo, y_in and y; {100 * bound_ms / ms:.1f}%); "
          f"the part stores {stored / 1e6:.1f} MB; kernel vs plain "
          f"{err:.2e}; the kernel's device time "
          + ("not measured (the profiler saw no kernel)" if dev_ms is None
             else f"{dev_ms:.4f} ms a call ({100 * bound_ms / dev_ms:.1f}% "
                  f"of bound; profiler, 100 calls of {dev['wall']:.4f} ms "
                  f"wall each)") + f"  [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, dev_ms=dev_ms)


def _stage_split(A, xs, card, tag="mlgeer"):
    """Where a card-shard matvec's time goes: on each card, each stage of
    its shards timed alone with CUDA events there (pack, the copies into
    it from other cards, unpack and the epilogue with CG's <x, y> are
    PyTorch; local and remote are B1), summed over its shards.  Without
    overlap a matvec takes at least the slowest card's sum."""
    stacks = Staging(A, xs[0].shape[1], A.dtype).stacks[0]
    opts = SpmvOpts(dot_xy=True)
    per = {}
    for c in A.cards:
        mine = [p for p, s in enumerate(A.shards) if s.device == c]
        stack = stacks[c]
        ms = dict.fromkeys(("pack", "copies in", "unpack", "local B1",
                            "remote B1", "epilogue"), 0.0)
        with torch.cuda.device(c):
            if any(p in mine for _, p, _, _ in A.copies):
                ms["copies in"] = time_ms(lambda: [
                    halo_exchange(A, p, stacks) for p in mine], 5, 20)
            for p in mine:
                halo = halo_unpack(A, p, stack)
                y_loc = local_stage(A, p, xs[p])
                ms["pack"] += time_ms(lambda: halo_pack(A, p, xs[p], stack))
                ms["unpack"] += time_ms(lambda: halo_unpack(A, p, stack))
                ms["local B1"] += time_ms(lambda: local_stage(A, p, xs[p]))
                ms["remote B1"] += time_ms(
                    lambda: remote_stage(A, p, halo, y_loc))
                ms["epilogue"] += time_ms(
                    lambda: fused_epilogue(y_loc, xs[p], opts))
        per[str(c)] = ms
        print(f"[{tag}] {c}: {len(mine)} shard(s), stages timed alone and "
              f"summed over them: " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in ms.items())
              + f" (sum {sum(ms.values()):.4f} ms)  [{card}]")
    return per


def _matvec_profile(eng, xs, b, card):
    """A card-only distributed matvec under ``torch.profiler``: per
    matvec, the wall time, the device time by kind of kernel and the time
    the card sat idle inside the window (the host's launches)."""
    run = eng.make_matvec(nvecs=b)
    run(xs)
    dev = _device_split(lambda: [run(xs) for _ in range(20)], 20)
    if dev is None:
        print(f"[mlgeer] {eng.A.nshards} card shards under the profiler: "
              f"not measured (the profiler saw no kernel)  [{card}]")
        return None
    print(f"[mlgeer] {eng.A.nshards} card shards under the profiler, per "
          f"matvec: wall {dev['wall']:.4f} ms; device "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(
              dev["kinds"].items())) + f"; the card idle {dev['idle']:.4f} "
          f"ms ({100 * dev['idle_share']:.1f}% of the window)  [{card}]")
    return dev


def _host_split(eng, x, b, card):
    """Where a host + card matvec's time goes: each shard's stages (CUDA
    events on the card, the host clock on the host), the copies between
    them, and a solver's staging of the host rows (down and back)."""
    A = eng.A
    xs = A.distribute_vec(x)
    run = eng.make_matvec(nvecs=b)
    run(xs)
    acc, tr = np.zeros(A.nshards), 0.0
    for _ in range(REBALANCE_CALLS):
        t = {}
        run(xs, times=t)
        acc += np.asarray(t["shards"])
        tr += t["transfer"]
    shard_ms = 1e3 * acc / REBALANCE_CALLS
    h = next(i for i, s in enumerate(A.shards) if s.device.type == "cpu")
    op = eng.operator()
    v = op.to_op_space(x.to(A.home))
    s = A.shards[h]
    part = v[s.offset:s.offset + s.nrows_pad]
    down = wall_ms(lambda: part.to("cpu"))
    back = part.to("cpu")
    up = wall_ms(lambda: back.to(A.home))
    parts = ", ".join(f"{sh.device.type} shard {ms:.4f} ms"
                      for sh, ms in zip(A.shards, shard_ms))
    print(f"[host split] {parts}; card<->host halo copies "
          f"{1e3 * tr / REBALANCE_CALLS:.4f} ms; host rows staged down "
          f"{down:.4f} ms and back {up:.4f} ms ({s.nrows_pad} x {b})  "
          f"[{card}]")
    return dict(shard_ms=shard_ms.tolist(),
                transfer_ms=1e3 * tr / REBALANCE_CALLS, down_ms=down,
                up_ms=up)


# ---------------------------------------------------------------- phase 15f
def _relres_cols(A64, b, x) -> torch.Tensor:
    """Per-column true relative residual of an original-space solution,
    through the one-device matrix' plain SpMV."""
    Ax, _, _ = sellcs_spmv_ref(A64, A64.permute(x))
    return (b - A64.unpermute(Ax)).norm(dim=0) / b.norm(dim=0)


def phase_engine_cg(fw, card):
    """Column CG (four right-hand sides, tol 1e-8) through DistOperator on
    laplace3d(NX): on ENGINE_SHARDS card shards and on the host plus the
    card, beside phase 6's one-device solve of the same system."""
    r, c, v, n = fw["coo"]
    A64 = fw["A64"]
    b = torch.from_numpy(fw["b_host"]).to(DEVICE)
    one_ms = 1e3 * fw["solve_s"]["f64"] / max(fw["iters64"], 1)
    one = make_operator(A64)
    b1 = A64.permute(b)
    out = {"launches": 0}
    for label, devs in ((f"{ENGINE_SHARDS} card shards",
                         [DEVICE] * ENGINE_SHARDS),
                        ("cpu + card", [DEVICE, "cpu"])):
        t0 = time.perf_counter()
        eng = HeterogeneousEngine(r, c, v, n, devices=devs, C=32, sigma=1024,
                                  dtype=np.float64)
        sync()
        build_s = time.perf_counter() - t0
        op = eng.operator()
        bop = op.to_op_space(b)
        execution.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        res = cg(op, bop, tol=ENGINE_TOL, maxiter=3000)
        sync()
        secs = time.perf_counter() - t0
        got = execution.launch_counts().get(KERNEL, 0)
        d = dropped("cg")
        want = (res.iters + d + 1) * _card_launches(eng.A)
        require(got == want, f"engine CG {label}: {got} B1 launches != "
                f"(iters + discarded + 1) x per-matvec = {want}")
        out["launches"] += got
        rel = _relres_cols(A64, b, op.from_op_space(res.x))
        require(bool(res.converged.all()), f"engine CG {label}: not converged")
        require(bool((rel <= 10 * ENGINE_TOL).all()),
                f"engine CG {label}: true residuals {rel.tolist()}")
        ms = 1e3 * secs / max(res.iters, 1)
        opts = SpmvOpts(dot_xy=True)         # CG's matvec
        mv_ms = wall_ms(lambda: op.mv_fused(bop, opts=opts))
        one_mv = wall_ms(lambda: one.mv_fused(b1, opts=opts))
        print(f"[engine cg] {label}: one matvec with <p, Ap> through "
              f"DistOperator {mv_ms:.4f} ms, through the one-device "
              f"operator {one_mv:.4f} ms  [{card}]")
        print(f"[engine cg] {label}: build {build_s:.1f} s; {_split_line(eng.A)};"
              f" {res.iters} iterations in {secs:.3f} s ({ms:.3f} ms/iter; "
              f"phase 6's one-device solve {fw['iters64']} iterations at "
              f"{one_ms:.3f} ms/iter), true rel residuals "
              f"{', '.join(f'{e:.2e}' for e in rel.tolist())} (tol "
              f"{ENGINE_TOL}), B1 launches {got}  [{card}]")
        out[label] = dict(iters=int(res.iters), ms=ms, eng=eng, mv_ms=mv_ms,
                          one_mv_ms=one_mv)
    return out


# ---------------------------------------------------------------- phase 15g
def phase_rebalance(eng, fw, card):
    """The rebalance loop on the host + card engine over laplace3d(NX):
    from the modeled weights, REBALANCE_STEPS steps on measured per-shard
    times, each generation's matvec held against the one-device SpMV."""
    A64 = fw["A64"]
    x = torch.from_numpy(fw["b_host"]).to(DEVICE)
    xp = A64.permute(x)
    y_ref = A64.unpermute(sellcs_spmv(A64, xp)[0])
    card_ms = wall_ms(lambda: sellcs_spmv(A64, xp))
    gens = []
    for gen in range(REBALANCE_STEPS + 1):
        A = eng.A
        y, _ = eng.spmv(x)
        err = rel_err(y, y_ref)
        require(err <= DIST_TOL, f"rebalance generation {gen}: {err:.3e} of "
                f"max|y| off the one-device SpMV")
        xs = A.distribute_vec(x)
        run = eng.make_matvec(nvecs=x.shape[1])
        run(xs)
        acc = np.zeros(A.nshards)
        for _ in range(REBALANCE_CALLS):
            t = {}
            run(xs, times=t)
            acc += np.asarray(t["shards"])
        times = acc / REBALANCE_CALLS
        op = eng.operator()
        v = op.to_op_space(x)
        mv_ms = wall_ms(lambda: op.mv(v))
        imb = eng.plan.imbalance(times)
        print(f"[rebalance] generation {gen}: weights "
              f"{'/'.join(f'{w:.4f}' for w in eng.plan.weights)}, rows "
              f"{'/'.join(str(int(s)) for s in eng.plan.sizes)}, shard ms "
              f"{'/'.join(f'{1e3 * t:.4f}' for t in times)} (max/mean "
              f"{imb:.3f}); matvec {mv_ms:.4f} ms against the card alone "
              f"{card_ms:.4f} ms; max|dy| {err:.2e} of max|y|  [{card}]")
        gens.append(dict(weights=list(eng.plan.weights),
                         rows=eng.plan.sizes.tolist(),
                         shard_ms=(1e3 * times).tolist(), imbalance=imb,
                         mv_ms=mv_ms))
        if gen < REBALANCE_STEPS:
            t0 = time.perf_counter()
            eng.rebalance(times)
            sync()
            print(f"[rebalance] step {gen + 1}: redistributed in "
                  f"{time.perf_counter() - t0:.1f} s")
    return dict(gens=gens, card_ms=card_ms)


# ---------------------------------------------------------------- phase 15h
def phase_engine_serving(eng, fw, card) -> int:
    """Engine-backed serving: the ENGINE_SHARDS-shard engine over
    laplace3d(NX) registered in a MatrixRegistry, CG requests drained
    through its DistOperator, every other one Chebyshev-preconditioned.
    Returns B1's launches."""
    A64 = fw["A64"]
    n = A64.nrows
    reg = MatrixRegistry()
    reg.register("lap_engine", eng)
    svc = SolverService(reg, block_width=PRECOND_WIDTH,
                        chunk_iters=SERVE_CHUNK)
    rng = np.random.default_rng(5)
    reqs = [(rng.standard_normal(n), None if i % 2 == 0 else
             ENGINE_SERVE_PRECOND) for i in range(ENGINE_SERVE_REQUESTS)]
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    tickets = [svc.submit("lap_engine", b, solver="cg", tol=ENGINE_TOL,
                          maxiter=3000, precond=pc) for b, pc in reqs]
    svc.drain()
    sync()
    wall = time.perf_counter() - t0
    got = execution.launch_counts().get(KERNEL, 0)
    require(got > 0 or DEVICE == "cpu", "engine serving: B1 not launched")
    require(all(t.status == "done" and t.result.converged for t in tickets),
            "engine serving: a request did not converge")
    X = torch.from_numpy(np.stack([t.result.x for t in tickets], 1))
    B = torch.from_numpy(np.stack([t.b for t in tickets], 1)).to(DEVICE)
    rel = _relres_cols(A64, B, X.to(DEVICE))
    require(bool((rel <= 10 * ENGINE_TOL).all()),
            f"engine serving: true residuals {rel.tolist()}")
    iters = {pc or "none": max(t.result.iters for t, (_, p) in
                               zip(tickets, reqs) if p == pc)
             for _, pc in reqs}
    print(f"[engine serve] {len(tickets)} CG requests on the "
          f"{eng.nshards}-shard engine ({ENGINE_SERVE_PRECOND} on every "
          f"other): all converged, largest true residual "
          f"{(rel / ENGINE_TOL).max().item():.2f} tol, iterations by "
          f"preconditioner {iters}, drained in {wall:.3f} s, B1 launches "
          f"{got}  [{card}]")
    return got


# ---------------------------------------------------------------- phase 15i
#: a CPU rehearsal of phase 15i: how many host devices stand in for cards
CROSS_REHEARSAL = ENGINE_SHARDS


def _cross_devices():
    """Phase 15i's devices, one shard each: every card of the machine."""
    if DEVICE == "cpu":
        return ["cpu"] * CROSS_REHEARSAL
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _between_cards(A, b) -> tuple:
    """Bytes one matvec moves between two cards: the halo copies, and
    ``DistOperator``'s split of x and join of y (every shard's slice off
    the home device, out and back)."""
    item = A.dtype.itemsize
    halo = sum(n for q, p, _, n in A.copies
               if "cuda" == A.devices[q].type == A.devices[p].type)
    off = sum(s.nrows_pad for s in A.shards if s.device != A.home)
    return halo * b * item, 2 * off * b * item


def _spans(prof, frag):
    """Per device index, the sorted time intervals (us) of the CUDA events
    whose name holds ``frag``."""
    out = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and frag in e.name):
            out.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    return {dev: sorted(iv) for dev, iv in out.items()}


def _cross_overlap(run, calls, card):
    """Where the copies ran, seen by the profiler over ``calls`` matvecs:
    per card (the card whose stream issued them), their time, how much
    of it a B1 kernel ran beside on that card, and how many began before
    the matvec's first B1 there (on the side stream, ahead of the local
    SpMV; a copy queued behind the local SpMV begins after it)."""
    from torch.profiler import ProfilerActivity, profile
    run()
    sync_cards()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        sync_cards()
    copies, b1 = _spans(prof, "Memcpy"), _spans(prof, "sellcs_spmv")
    if not copies:
        print(f"[cross] copies under the profiler: not measured (the "
              f"profiler saw no copy)  [{card}]")
        return None
    out = {}
    for dev, cs in sorted(copies.items()):
        ks = b1.get(dev, [])
        per = max(1, round(len(ks) / calls))      # B1 launches a matvec
        ahead = sum(sum(e <= a for _, e in ks) % per == 0 for a, _ in cs)
        beside = sum(max(0.0, min(b, d) - max(a, c))
                     for a, b in cs for c, d in ks)
        out[dev] = dict(n=len(cs), ahead=ahead,
                        ms=sum(b - a for a, b in cs) * 1e-3 / calls,
                        beside_ms=beside * 1e-3 / calls)
    print(f"[cross] copies under the profiler, {calls} matvecs: " + "; ".join(
        f"card {dev} {o['n']} copies, {o['ms']:.4f} ms a matvec, "
        f"{o['beside_ms']:.4f} of it beside B1, {o['ahead']} began before "
        f"the matvec's first B1 there" for dev, o in out.items())
        + f"  [{card}]")
    return out


def phase_cross_cards(mlg, ecg, fw, card):
    """Slice 14's main path: the engine with one shard a card.
    ``mlgeer_like`` (phase 15e's partition moved card by card where the
    card count is ENGINE_SHARDS) against the same shards on one card, bit
    for bit, and against the one-device plain SpMV; overlap against none;
    the double-buffered chain; B1's launches; ms a matvec; the stage
    split and the overlap under the profiler; the bytes between cards;
    then the host + every card plan, and CG through DistOperator on
    laplace3d(NX) against phase 15f.  Says so, and checks nothing, where
    the machine has fewer than two cards."""
    devs = _cross_devices()
    k = len(devs)
    if DEVICE == "cuda":
        peers = ", ".join(f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
                          for i in range(k) for j in range(k) if i != j)
        print(f"[cross] torch.cuda.device_count() {k}; "
              f"can_device_access_peer: {peers or 'no pair'}")
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True, check=False)
        print("[cross] nvidia-smi topo -m:\n"
              + (topo.stdout.rstrip() or topo.stderr.rstrip()))
    if k < 2:
        print(f"[cross] NOT RUN: the engine across cards needs two cards or"
              f" more, and this machine has {k}; nothing of phase 15i was "
              f"checked on this call  [{card}]")
        return {"ran": False, "launches": 0}
    keep = mlg["keep"]
    x, y_ref, b = keep["x"], keep["y_ref"], keep["x"].shape[1]
    out = {"ran": True, "launches": 0}
    if k == ENGINE_SHARDS:
        one = keep["eng"]
    else:
        t0 = time.perf_counter()
        one = HeterogeneousEngine(*keep["coo"], devices=[devs[0]] * k,
                                  **keep["kw"])
        print(f"[cross] {k} shards on one card: built in "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    many = one.on(devs)
    sync_cards()
    move_s = time.perf_counter() - t0
    A = many.A
    opts = SpmvOpts(dot_yy=True, dot_xy=True, dot_xx=True)
    y1, d1 = one.spmv(x, opts=opts)
    execution.reset_launch_counts()
    y, d = many.spmv(x, opts=opts)
    sync_cards()
    got = execution.launch_counts().get(KERNEL, 0)
    require(got == _card_launches(A), f"cross mlgeer: {got} B1 launches, "
            f"expected {_card_launches(A)}")
    out["launches"] += got
    require(torch.equal(y, y1) and torch.equal(d, d1),
            "cross mlgeer: y or the dots differ from the same shards on one "
            "card")
    err = rel_err(y, y_ref)
    require(err <= DIST_TOL, f"cross mlgeer: {err:.3e} of max|y| off the "
            f"plain one-device SpMV")
    yn, dn = many.spmv(x, opts=opts, overlap=False)
    require(torch.equal(y, yn) and torch.equal(d, dn),
            "cross mlgeer: overlap changed bits")
    xs, xs1 = A.distribute_vec(x), one.A.distribute_vec(x)
    run_db = many.make_matvec(nvecs=b, double_buffer=True)
    run_nb = many.make_matvec(nvecs=b)
    w, w2, stg = xs, xs, None
    for _ in range(3):
        w, _, stg = run_db(w, staging=stg)
        w2, _, _ = run_nb(w2)
    require(all(torch.equal(a, c) for a, c in zip(w, w2)),
            "cross mlgeer: double-buffered chain differs")
    ms = {True: [], False: []}
    one_ms = []
    for _ in range(2):
        one_ms.append(wall_ms(lambda: one.make_matvec(nvecs=b)(xs1),
                              wait=sync_cards))
        for ov in (True, False):
            ms[ov].append(wall_ms(lambda: many.make_matvec(
                nvecs=b, overlap=ov)(xs), wait=sync_cards))
    out["ms"], out["one_ms"] = ms, one_ms
    halo_b, split_b = _between_cards(A, b)
    out["split_join_bytes"] = split_b
    op, op1 = many.operator(), one.operator()
    v = op.to_op_space(x.to(A.home))
    v1 = op1.to_op_space(x.to(one.A.home))
    mv_ms, mv1_ms = (wall_ms(lambda: op.mv(v), wait=sync_cards),
                     wall_ms(lambda: op1.mv(v1), wait=sync_cards))
    print(f"[cross] {MLGEER} on {k} cards, one shard a card (moved from one"
          f" card in {move_s:.1f} s): {_split_line(A)}; y and the dots equal"
          f" the same shards on one card bit for bit, max|dy| {err:.2e} of "
          f"max|y| against the plain one-device SpMV; overlap == no overlap "
          f"and the double-buffered chain == unbuffered bit for bit; B1 "
          f"launches {got}; ms a matvec in turns: on one card "
          f"{' / '.join(f'{t:.4f}' for t in one_ms)}, across cards with "
          f"overlap {' / '.join(f'{t:.4f}' for t in ms[True])}, without "
          f"{' / '.join(f'{t:.4f}' for t in ms[False])}; between cards a "
          f"matvec: halo copies {halo_b} B, DistOperator's split and join "
          f"{split_b} B; DistOperator.mv {mv_ms:.4f} ms against "
          f"{mv1_ms:.4f} on one card  [{card}]")
    if DEVICE == "cuda":
        out["stages"] = _stage_split(A, xs, card, "cross")
        out["overlap"] = _cross_overlap(
            lambda: many.make_matvec(nvecs=b)(xs), 20, card)
    del w, w2, stg, xs, xs1, op, op1, v, v1, y1, d1, y, d, yn, dn
    if k != ENGINE_SHARDS:
        del one
    del many, A

    # the host + every card plan: the pool's weights
    t0 = time.perf_counter()
    heng = HeterogeneousEngine(*keep["coo"], devices=devs + ["cpu"],
                               **keep["kw"])
    sync_cards()
    build_s = time.perf_counter() - t0
    execution.reset_launch_counts()
    yh, _ = heng.spmv(x)
    sync_cards()
    got = execution.launch_counts().get(KERNEL, 0)
    require(got == _card_launches(heng.A), f"cross host + cards: {got} B1 "
            f"launches, expected {_card_launches(heng.A)}")
    out["launches"] += got
    err = rel_err(yh, y_ref)
    require(err <= DIST_TOL, f"cross host + cards: {err:.3e} of max|y| off")
    xsh = heng.A.distribute_vec(x)
    out["host_ms"] = wall_ms(lambda: heng.make_matvec(nvecs=b)(xsh),
                             wait=sync_cards)
    print(f"[cross] host + {k} cards: build {build_s:.1f} s; "
          f"{_split_line(heng.A)}; max|dy| {err:.2e} of max|y|; B1 launches"
          f" {got}; {out['host_ms']:.4f} ms a matvec  [{card}]")
    del heng, xsh, yh

    # CG through DistOperator on laplace3d(NX), one shard a card
    r, c, v_, n = fw["coo"]
    A64 = fw["A64"]
    bvec = torch.from_numpy(fw["b_host"]).to(DEVICE)
    base = ecg[f"{ENGINE_SHARDS} card shards"]
    if k == ENGINE_SHARDS:
        eng1, base_iters = base["eng"], base["iters"]
    else:
        eng1 = HeterogeneousEngine(r, c, v_, n, devices=[devs[0]] * k,
                                   C=32, sigma=1024, dtype=np.float64)
        op1 = eng1.operator()
        base_iters = int(cg(op1, op1.to_op_space(bvec), tol=ENGINE_TOL,
                            maxiter=3000).iters)
    ceng = eng1.on(devs)
    op = ceng.operator()
    bop = op.to_op_space(bvec)
    execution.reset_launch_counts()
    sync_cards()
    t0 = time.perf_counter()
    res = cg(op, bop, tol=ENGINE_TOL, maxiter=3000)
    sync_cards()
    secs = time.perf_counter() - t0
    got = execution.launch_counts().get(KERNEL, 0)
    want = (res.iters + dropped("cg") + 1) * _card_launches(ceng.A)
    require(got == want, f"cross CG: {got} B1 launches != (iters + "
            f"discarded + 1) x per-matvec = {want}")
    out["launches"] += got
    rel = _relres_cols(A64, bvec, op.from_op_space(res.x))
    require(bool(res.converged.all()), "cross CG: not converged")
    require(bool((rel <= 10 * ENGINE_TOL).all()),
            f"cross CG: true residuals {rel.tolist()}")
    require(int(res.iters) == base_iters, f"cross CG: {res.iters} "
            f"iterations, {base_iters} with the same shards on one card")
    out["cg_iters"] = int(res.iters)
    mv_ms = wall_ms(lambda: op.mv_fused(bop, opts=SpmvOpts(dot_xy=True)),
                    wait=sync_cards)
    halo_b, split_b = _between_cards(ceng.A, bvec.shape[1])
    print(f"[cross] CG through DistOperator on laplace3d("
          f"{round(n ** (1 / 3))}), {k} cards: "
          f"{res.iters} iterations (the same shards on one card: "
          f"{base_iters}) in {secs:.3f} s ({1e3 * secs / max(res.iters, 1):.3f}"
          f" ms/iter), true rel residuals "
          f"{', '.join(f'{e:.2e}' for e in rel.tolist())} (tol {ENGINE_TOL}),"
          f" B1 launches {got}; one matvec with <p, Ap> {mv_ms:.4f} ms, "
          f"moving {halo_b} B of halo and {split_b} B of split and join "
          f"between cards  [{card}]")
    out["cg_ms"] = 1e3 * secs / max(res.iters, 1)
    return out


# ----------------------------------------------------------------- phase 16
def _b6_inputs(B, S, di, N, seed):
    """dt >= 0 from 0 to large (a tenth of the entries 0, a tenth
    log-uniform in [1, 300], so that exp(dt A) underflows), A <= 0 with a
    column of zeros (no decay: the longest accumulation)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    def uni(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    dt = rnd(B, S, di).abs() * 0.1
    dt = torch.where(uni(B, S, di) < 0.1, 0.0, dt)
    big = torch.exp(uni(B, S, di) * float(np.log(300.0)))
    dt = torch.where(uni(B, S, di) < 0.1, big, dt)
    A = -torch.exp(rnd(di, N))
    A[:, 0] = 0.0
    return dt, rnd(B, S, di), rnd(B, S, N), rnd(B, S, N), A


def _b6_check(args, tag, worst):
    """Kernel (plain version on the CPU) against the plain version in
    float64, held to ``error_bound``; the worst ratio per N in ``worst``."""
    got = mamba_scan(*args)
    want = mamba_scan_ref(*(a.double() for a in args))
    bound = scan_error_bound(*args)
    err = (got.double() - want).abs()
    ratio = float((err / bound).max()) if err.numel() else 0.0
    N = args[4].shape[1]
    if ratio > worst.get(N, (0.0, ""))[0]:
        worst[N] = (ratio, tag)
    require(got.dtype == torch.float32 and got.shape == want.shape,
            f"B6 {tag}: {got.dtype} {tuple(got.shape)}")
    require(ratio <= 1.0, f"B6 {tag}: error {ratio:.3f} of its bound")
    return float(err.max()) if err.numel() else 0.0


def phase_b6_grid() -> None:
    """B6 against its plain version in float64 over batch, sequence,
    d_inner and state sizes, each output held to ``error_bound``: twice
    the first-order float32 rounding of the recurrence (ex2.approx.ftz
    within 2 ulp of the rounded 2^x, the exponent dt A log2(e) rounded
    three times, a result below 2^-126 flushed to 0, two products and a
    sum per step, N terms in y), about (7 + 3 |dt A|) u per step and
    2^-126 absolute per factor on the decayed state and 3 u on each new
    term, so the bound grows with the steps a term survives."""
    worst, n = {}, 0
    for B in B6_B:
        for S in B6_S:
            for di in B6_DI:
                for N in B6_N:
                    args = _b6_inputs(B, S, di, N, seed=n)
                    _b6_check(args, f"B={B} S={S} di={di} N={N}", worst)
                    n += 1
    sync()
    print(f"[b6 grid] {n} cases (B {B6_B}, S {B6_S}, d_inner {B6_DI}, "
          f"N {B6_N}; dt from 0 to 300, A <= 0) within 2 x first-order "
          f"bound")
    for N, (r, tag) in sorted(worst.items()):
        print(f"[b6 grid]   N={N}: worst {r:.3f} of the bound ({tag})")


def phase_b6_exp2() -> None:
    """B6's exponential, ``ex2.approx.ftz.f32`` (``exp2_cuda``; on the CPU
    ``torch.exp2`` flushed below 2^-126 stands in), on every finite
    float32 argument <= 0 (+0, -0 and the bit patterns down to -FLT_MAX)
    against ``torch.exp2`` in float64.  Gates, the constants
    ``error_bound`` charges: where 2^x >= 2^-125 (an error of a few ulp
    cannot reach the flushed range there) at most EXP_ULP ulp from the
    correctly rounded 2^x; where 2^x < 2^-126 (the subnormal range) at
    most EXP_FLUSH; and everywhere |error| <= EXP_REL 2^x + EXP_FLUSH."""
    u = 2.0 ** -24
    end = 0x7F800000                          # the magnitude bits of -inf
    worst = {key: (0.0, None) for key in ("ulp", "rel", "abs", "model")}
    n = 0
    for lo in range(-1, end, EXP2_CHUNK * EXP2_STRIDE):
        hi = min(end, lo + EXP2_CHUNK * EXP2_STRIDE)
        # -1 stands for +0, i >= 0 for the negative float of magnitude bits i
        bits = torch.arange(lo, hi, EXP2_STRIDE, dtype=torch.int64,
                            device=DEVICE)
        x = torch.where(bits < 0, 0, bits - (1 << 31)).to(
            torch.int32).view(torch.float32)
        del bits
        if DEVICE == "cuda":
            r = exp2_cuda(x)
        else:
            r = torch.exp2(x)
            r = torch.where(r < EXP_FLUSH, 0.0, r)
        exact = torch.exp2(x.double())
        normal = exact >= 2.0 ** -125
        # ulp from the correctly rounded 2^x: the distance of two positive
        # floats' bit patterns
        ulps = (r.view(torch.int32).long()
                - exact.float().view(torch.int32).long()).abs()
        err = (r.double() - exact).abs()
        del r
        for key, e in (("ulp", torch.where(normal, ulps.double(), 0.0)),
                       ("rel", torch.where(normal, err / exact / u, 0.0)),
                       ("abs", torch.where(exact < 2.0 ** -126, err, 0.0)),
                       ("model", err / (EXP_REL * exact + EXP_FLUSH))):
            k = int(e.argmax())
            if float(e[k]) > worst[key][0]:
                worst[key] = (float(e[k]), float(x[k]))
        n += x.numel()
        del x, exact, normal, ulps, err, e
    sync()
    (w_ulp, x_ulp), (w_rel, x_rel), (w_abs, x_abs), (w_model, _) = (
        worst[k] for k in ("ulp", "rel", "abs", "model"))
    print(f"[b6 exp2] ex2.approx.ftz.f32 on {n} float32 arguments <= 0 "
          f"(stride {EXP2_STRIDE}) against exp2 in float64, where 2^x >= "
          f"2^-125: largest error {w_ulp:.0f} ulp from the correctly rounded "
          f"2^x (x = {x_ulp!r}; stated {EXP_ULP}), largest relative error "
          f"{w_rel:.4f} u (x = {x_rel!r}; stated {EXP_REL / u:.0f} u); where "
          f"2^x < 2^-126: worst absolute error {w_abs:.4e} (x = {x_abs!r}; "
          f"stated 2^-126 = {EXP_FLUSH:.4e}); largest error {w_model:.4f} of "
          f"{EXP_REL / u:.0f}u 2^x + 2^-126")
    require(w_ulp <= EXP_ULP, f"B6 exp2: {w_ulp} ulp > {EXP_ULP}")
    require(w_abs <= EXP_FLUSH, f"B6 exp2: {w_abs:.4e} > 2^-126")
    require(w_model <= 1.0, f"B6 exp2: {w_model} of its model")


# ----------------------------------------------------------------- phase 17
def lm_config(dtype):
    """The full-width path's model: jamba-1.5-large at its published widths
    (``LM_WIDTHS = "full"``; the registered SMOKE widths in a CPU
    rehearsal), one period of 8 layers (7 Mamba, attention at index 4), a
    dense SwiGLU FFN in every slot instead of MoE, scan_impl "kernel"."""
    base = (get_smoke_config(LM_ARCH) if LM_WIDTHS == "smoke"
            else get_config(LM_ARCH))
    return dataclasses.replace(
        base, n_layers=base.period, moe=None, dtype=dtype,
        pattern=tuple((mix, "mlp") for mix, _ in base.pattern),
        ssm=dataclasses.replace(base.ssm, scan_impl="kernel"))


def _n_mamba(cfg) -> int:
    return sum(mix == "mamba" for mix, _ in cfg.full_pattern())


def _tokens(cfg, B, S, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device=DEVICE)


def _forward_timed(cfg, model, tokens):
    sync()
    t0 = time.perf_counter()
    logits, _ = T.forward(cfg, model, {"tokens": tokens})
    sync()
    return logits, time.perf_counter() - t0


def phase_prefill(card):
    """Slice 8a's main path: ``forward`` (the serving prefill) of jamba at
    full width in bfloat16, through B6 in each Mamba layer."""
    cfg = lm_config(torch.bfloat16)
    sync()
    t0 = time.perf_counter()
    model = T.init_params(cfg, LM_SEED, DEVICE)
    sync()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[prefill] {cfg.name} widths d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"d_inner={cfg.ssm.inner(cfg.d_model)} N={cfg.ssm.d_state}, "
          f"{cfg.n_layers} layers {[m for m, _ in cfg.pattern]}, dense FFN "
          f"in every slot: {T.param_count(model) / 1e9:.3f} G parameters, "
          f"{nbytes / 1e9:.2f} GB bf16, made from seed {LM_SEED} in "
          f"{time.perf_counter() - t0:.1f} s")
    tokens = _tokens(cfg, LM_BATCH, LM_SEQ, seed=1)
    execution.reset_launch_counts()
    logits, secs = _forward_timed(cfg, model, tokens)
    launches = execution.launch_counts().get("mamba_scan", 0)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    _, warm = _forward_timed(cfg, model, tokens)
    ntok = LM_BATCH * LM_SEQ
    print(f"[prefill] forward B={LM_BATCH} S={LM_SEQ}: first {secs:.3f} s, "
          f"again {warm:.3f} s ({ntok / warm:.0f} tokens/s); logits {shape} "
          f"finite={finite}; mamba_scan launches {launches} (one per Mamba "
          f"layer: {_n_mamba(cfg)})  [{card}]")
    require(finite, "prefill: non-finite logits")
    require(shape == (LM_BATCH, LM_SEQ, cfg.padded_vocab),
            f"prefill: logits {shape}")
    require(launches == _n_mamba(cfg) or DEVICE == "cpu",
            f"prefill: mamba_scan launches {launches} != {_n_mamba(cfg)}")
    return dict(cfg=cfg, model=model, tokens=tokens, launches=launches,
                secs=warm, tokens_per_s=ntok / warm)


def phase_prefill_split(lm, card, sampler):
    """Where one full-width forward goes: each layer's mixer and FFN, B6
    and the LM head, timed alone with CUDA events on inputs of the
    forward's shapes (the embedding output stands in for each layer's
    input), with the SM clock while B6 ran (``sampler``).  Returns B6's
    inputs there, the first Mamba layer's, on the host."""
    cfg, model, tokens = lm["cfg"], lm["model"], lm["tokens"]
    x = L.embed_apply(model.embed, tokens)
    pos = torch.arange(LM_SEQ, device=DEVICE).expand(LM_BATCH, LM_SEQ)
    parts = {"mamba_scan (B6)": 0.0, "Mamba layers without B6": 0.0,
             "attention layer": 0.0, "FFNs": 0.0, "final norm + LM head": 0.0}
    b6_ms = None
    for p in model.decoder:
        for i, (mix, ffn) in enumerate(cfg.pattern):
            pm = p[f"l{i}_mix"]
            ms = time_ms(lambda: T._apply_mixer(
                cfg, pm, x, mix, positions=pos, positions3=None),
                warmup=1, iters=3)
            if mix == "mamba":
                if b6_ms is None:
                    h = L.apply_norm(cfg.norm, pm["norm"], x)
                    dt, xc, Bc, Cc, A, _ = SSM._scan_inputs(pm["mamba"], h,
                                                            cfg.ssm)
                    scan_args = (dt, xc.float(), Bc, Cc, A.contiguous())
                    t0 = time.perf_counter()
                    b6_ms = time_ms(lambda: mamba_scan(*scan_args),
                                    warmup=1, iters=5)
                    b6_window = (t0, time.perf_counter())
                    # kept on the host for the B6 timing phase
                    scan_args = tuple(t.cpu() for t in scan_args)
                    del h, dt, xc, Bc, Cc, A
                parts["mamba_scan (B6)"] += b6_ms
                parts["Mamba layers without B6"] += ms - b6_ms
            else:
                parts["attention layer"] += ms
            parts["FFNs"] += time_ms(lambda: T._apply_ffn(
                cfg, p[f"l{i}_ffn"], x, ffn), warmup=1, iters=3)
    parts["final norm + LM head"] = time_ms(lambda: L.lm_head_apply(
        model.embed, L.apply_norm(cfg.norm, model.final_norm, x),
        model.lm_head), warmup=1, iters=3)
    total = 1e3 * lm["secs"]
    print(f"[prefill split] one forward = {total:.1f} ms (B={LM_BATCH}, "
          f"S={LM_SEQ}, bf16; host clock)  [{card}]")
    for name, ms in parts.items():
        print(f"[prefill split]   {name:24s} {ms:9.2f} ms "
              f"({100 * ms / total:.1f}%)")
    rest = total - sum(parts.values())
    print(f"[prefill split]   {'rest (embedding, launches)':24s} "
          f"{rest:9.2f} ms ({100 * rest / total:.1f}%)")
    print(f"[prefill split] one B6 call {b6_ms:.4f} ms (warm-up 1, 5 calls, "
          f"right after the layer's projections): "
          f"{sampler.during(*b6_window)}")
    return scan_args


# ----------------------------------------------------------------- phase 18
def phase_serve(lm, card) -> None:
    """``launch.serve.generate`` on the full-width model: the prompt token
    by token through ``decode_step``, then greedy decode (plain PyTorch:
    the decode step has no scan)."""
    cfg, model = lm["cfg"], lm["model"]
    prompts = _tokens(cfg, LM_BATCH, SERVE_PROMPT, seed=2)
    execution.reset_launch_counts()
    out = generate(cfg, model, prompts, SERVE_GEN)
    launches = execution.launch_counts().get("mamba_scan", 0)
    toks = out.tokens
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    n_dec = SERVE_GEN - 1
    print(f"[serve] generate B={LM_BATCH} prompt={SERVE_PROMPT} "
          f"gen={SERVE_GEN}: prefill {1e3 * out.prefill_s:.1f} ms "
          f"({1e3 * out.prefill_s / SERVE_PROMPT:.2f} ms/token step), "
          f"decode {1e3 * out.decode_s / n_dec:.2f} ms/token step "
          f"({LM_BATCH * n_dec / out.decode_s:.1f} tokens/s), tokens in "
          f"the vocabulary: {in_vocab}, mamba_scan launches {launches}  "
          f"[{card}]")
    print(f"[serve] first generations: {toks[:2, :8].tolist()}")
    require(tuple(toks.shape) == (LM_BATCH, SERVE_GEN),
            f"serve: tokens {tuple(toks.shape)}")
    require(in_vocab, "serve: a token outside the vocabulary")
    require(bool(torch.isfinite(out.logits).all()), "serve: non-finite logits")


# ----------------------------------------------------------------- phase 19
def phase_decode_vs_forward(card) -> None:
    """The full-width model in float32, B=1: the logits of ``forward``
    (through B6) against those of ``DECODE_SEQ`` ``decode_step`` calls
    (plain PyTorch, no kernel).  Gate: max |diff| <= DECODE_TOL * max
    |logit|; the two paths sum every product in other orders (online
    against direct attention, a sequence-wide scan against one step at a
    time, other GEMM shapes), and the longest contraction (d_ff = 24576)
    alone allows 24576 u = 1.5e-3 relative; a wrong state in B6 moves the
    logits by O(1)."""
    cfg = lm_config(torch.float32)
    model = T.init_params(cfg, LM_SEED, DEVICE)
    tokens = _tokens(cfg, 1, DECODE_SEQ, seed=3)
    execution.reset_launch_counts()
    ref, secs = _forward_timed(cfg, model, tokens)
    launches = execution.launch_counts().get("mamba_scan", 0)
    cache = T.init_cache(cfg, 1, DECODE_SEQ, DEVICE)
    outs = []
    sync()
    t0 = time.perf_counter()
    for t in range(DECODE_SEQ):
        logits, cache = T.decode_step(cfg, model, cache, tokens[:, t:t + 1], t)
        outs.append(logits[:, 0])
    sync()
    dsecs = time.perf_counter() - t0
    dec = torch.stack(outs, dim=1)
    diff = float((dec - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[decode vs forward] f32, B=1, S={DECODE_SEQ}: forward {secs:.3f} "
          f"s ({launches} mamba_scan launches), {DECODE_SEQ} decode steps "
          f"{dsecs:.3f} s; max |decode - forward| {diff:.3e} = "
          f"{diff / scale:.3e} of max |logit| {scale:.3f} (tol "
          f"{DECODE_TOL})  [{card}]")
    require(bool(torch.isfinite(ref).all()), "decode vs forward: non-finite")
    require(diff <= DECODE_TOL * scale,
            f"decode vs forward: {diff / scale:.3e} > {DECODE_TOL}")
    require(launches == _n_mamba(cfg) or DEVICE == "cpu",
            f"f32 forward: mamba_scan launches {launches}")


# ----------------------------------------------------------------- phase 20
def phase_moe(card) -> None:
    """The registered SMOKE jamba (MoE, 4 experts, top 2) with weights from
    a seed: ``forward`` (through B6) and decode on the card against the
    port's own CPU run of the same weights.  As in the CPU parity tests,
    the router weights are multiplied by 20 and the capacity factor is 8,
    so near-tie expert choices cannot flip between the two devices.  Gate:
    max |card - CPU| <= MOE_TOL * max |logit| (float32 round-off of eight
    layers in other summation orders)."""
    base = get_smoke_config(LM_ARCH)
    cfg = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=8.0),
        ssm=dataclasses.replace(base.ssm, scan_impl="kernel"))
    host = T.init_params(cfg, LM_SEED, "cpu")
    for name, w in host.named_parameters():
        if name.endswith("router"):
            w.mul_(20.0)
    card_model = copy.deepcopy(host).to(DEVICE)
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(4))
    execution.reset_launch_counts()
    got, aux = T.forward(cfg, card_model, {"tokens": tok.to(DEVICE)})
    sync()
    launches = execution.launch_counts().get("mamba_scan", 0)
    want, want_aux = T.forward(cfg, host, {"tokens": tok})
    err = rel_err(got.cpu(), want)
    cd, hd = (T.init_cache(cfg, 2, 4, dev) for dev in (DEVICE, "cpu"))
    derr = 0.0
    for t in range(4):
        a, cd = T.decode_step(cfg, card_model, cd, tok[:, t:t + 1].to(DEVICE),
                              t)
        b, hd = T.decode_step(cfg, host, hd, tok[:, t:t + 1], t)
        derr = max(derr, rel_err(a.cpu(), b))
    print(f"[moe] {cfg.name} ({cfg.moe.n_experts} experts, top "
          f"{cfg.moe.top_k}): card against CPU, forward {err:.3e} (aux "
          f"{float(aux):.6f} / {float(want_aux):.6f}), 4 decode steps "
          f"{derr:.3e} of max |logit| (tol {MOE_TOL}); mamba_scan launches "
          f"{launches}  [{card}]")
    require(err <= MOE_TOL and derr <= MOE_TOL,
            f"moe: card differs from CPU by {max(err, derr):.3e}")
    require(abs(float(aux) - float(want_aux)) <= MOE_TOL * abs(float(want_aux)),
            "moe: load-balancing loss differs")
    require(launches == _n_mamba(cfg) or DEVICE == "cpu",
            f"moe forward: mamba_scan launches {launches}")


# ----------------------------------------------------------------- phase 21
#: exponentials the special-function units issue per clock and SM (Hopper)
SFU_EXP_PER_CLK = 16


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


#: what ``ClockSampler`` reads, and the names of the throttle reasons' bits
CLOCK_QUERY = "clocks.sm,power.draw,clocks_throttle_reasons.active"
THROTTLE_BITS = {0x1: "idle", 0x2: "application clocks", 0x4: "SW power cap",
                 0x8: "HW slowdown", 0x10: "sync boost", 0x20: "SW thermal",
                 0x40: "HW thermal", 0x80: "HW power brake",
                 0x100: "display clocks"}


class ClockSampler:
    """``nvidia-smi`` in the background, reading the SM clock, the power
    draw and the active throttle reasons every 5 ms, so that a timed
    window can say what the card ran at.  A context manager: the process
    ends on exit."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={CLOCK_QUERY}",
             "--format=csv,noheader,nounits", "-lms", "5"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        deadline = time.perf_counter() + 5.0     # nvidia-smi's start-up
        while (not self.samples and self.proc.poll() is None
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        return self

    def _read(self):
        for line in self.proc.stdout:
            self.samples.append((time.perf_counter(), line.strip()))

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait()
        self.reader.join()

    def during(self, t0: float, t1: float) -> str:
        """The samples taken between host times ``t0`` and ``t1`` (the
        nearest one if none was)."""
        got = [(t, line) for t, line in self.samples if t0 <= t <= t1]
        where = f"{len(got)} samples in the window"
        if not got and self.samples:
            t, line = min(self.samples, key=lambda s: min(abs(s[0] - t0),
                                                          abs(s[0] - t1)))
            got = [(t, line)]
            where = (f"no sample in the window; nearest "
                     f"{1e3 * (t - t1 if t > t1 else t - t0):+.0f} ms from it")
        rows = [[f.strip() for f in line.split(",")] for _, line in got]
        rows = [r for r in rows if len(r) == 3
                and all(re.fullmatch(r"[0-9.]+|0x[0-9a-fA-F]+", f) for f in r)]
        if not rows:
            return f"no clock sample ({[line for _, line in got][:1]})"
        clocks = [float(r[0]) for r in rows]
        watts = [float(r[1]) for r in rows]
        mask = 0
        for r in rows:
            mask |= int(r[2], 16)
        why = "+".join(n for b, n in THROTTLE_BITS.items() if mask & b)
        return (f"SM clock {min(clocks):.0f}-{max(clocks):.0f} MHz, power "
                f"{min(watts):.0f}-{max(watts):.0f} W, throttle reasons "
                f"{why or 'none'} ({where})")


#: the B6 gap trials: repeats of each, and bf16 products of in_proj's shape
#: run just before a "hot" trial (as the split times B6 right after the
#: layer's projections)
B6_GAP_REPEATS, B6_HOT_PRODUCTS = 3, 30


def _b6_gap(card, sampler, inputs, in_proj):
    """B6 back to back on each set of ``inputs`` under the split's protocol
    (warm-up 1, 5 calls) and the timing phase's (warm-up 3, 20 calls),
    each on an idle card and right after ``B6_HOT_PRODUCTS`` products of
    ``in_proj``'s shape, with the clock sampled during each window."""
    a, w = in_proj
    out = torch.empty((a.shape[0], w.shape[1]), dtype=a.dtype, device=DEVICE)
    for label, args in inputs.items():
        for warmup, iters in ((1, 5), (3, 20)):
            for hot in (False, True):
                times = []
                for _ in range(B6_GAP_REPEATS):
                    sync()
                    if hot:
                        for _ in range(B6_HOT_PRODUCTS):
                            torch.matmul(a, w, out=out)
                    else:
                        time.sleep(0.5)
                    t0 = time.perf_counter()
                    times.append(time_ms(lambda: mamba_scan(*args),
                                         warmup=warmup, iters=iters))
                    t1 = time.perf_counter()
                print(f"[b6 gap] {label}, warm-up {warmup} + {iters} calls, "
                      f"{'after the products' if hot else 'idle card'}: "
                      f"{' / '.join(f'{t:.4f}' for t in times)} ms; last "
                      f"window: {sampler.during(t0, t1)}  [{card}]")


def phase_b6_timing(card, model_args):
    """B6 at the main shape (B 4, S 4096, d_inner 16384, N 16): kernel, the
    plain version once, and the bound: the larger of the bytes (dt, xc,
    Bc, Cc, A read once, y written once) over 3.35 TB/s and the
    exponentials (B S di N) at 16 per clock per SM.  Then why B6 runs
    slower inside the prefill split than here (``_b6_gap``), on the grid's
    inputs (dt clamped to 1) and on the model's own (``model_args``: the
    first Mamba layer's ``SSM._scan_inputs`` in the split, dt near
    softplus(-4.6), A = -(1..16)), each held to ``error_bound`` too; with
    the SM clock and the throttle reasons sampled during every window."""
    cfg = lm_config(torch.bfloat16)
    B, S, di, N = LM_BATCH, LM_SEQ, cfg.ssm.inner(cfg.d_model), cfg.ssm.d_state
    args = list(_b6_inputs(B, S, di, N, seed=21))
    args[0] = args[0].clamp(max=1.0)          # dt as the model has it
    model_args = [t.to(DEVICE) for t in model_args]
    require(tuple(model_args[0].shape) == (B, S, di)
            and tuple(model_args[4].shape) == (di, N),
            f"B6 timing: model inputs {[tuple(t.shape) for t in model_args]}")
    errs = {}
    for label, a in (("grid", args), ("model", model_args)):
        y = mamba_scan(*a)
        want = mamba_scan_ref(*(t.double() for t in a))
        diff = (y.double() - want).abs()
        del want
        errs[label] = (float(diff.max()),
                       float((diff / scan_error_bound(*a)).max()))
        del diff
    with ClockSampler() as sampler:
        t0 = time.perf_counter()
        ms = time_ms(lambda: mamba_scan(*args), warmup=3, iters=20)
        clock_note = sampler.during(t0, time.perf_counter())
        t0 = time.perf_counter()
        model_ms = time_ms(lambda: mamba_scan(*model_args), warmup=3,
                           iters=20)
        model_note = sampler.during(t0, time.perf_counter())
        sync()
        t0 = time.perf_counter()
        mamba_scan_ref(*args)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = _nbytes(*args, y)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        props = torch.cuda.get_device_properties(0)
        clock = _sm_clock_hz()
        nexp = B * S * di * N
        exp_ms = 1e3 * nexp / (SFU_EXP_PER_CLK * props.multi_processor_count
                               * clock)
        flops_ms = 1e3 * 5.0 * nexp / PEAK_FLOPS[torch.float32]
        ops_ms = max(exp_ms, flops_ms)
        bound_ms = max(bytes_ms, ops_ms)
        err, ratio = errs["grid"]
        print(f"[timing] mamba_scan f32 B={B} S={S} di={di} N={N}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms (once), library n/a (no "
              f"single PyTorch call computes a selective scan), bound "
              f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms for "
              f"{nbytes / 1e9:.3f} GB; {nexp / 1e9:.2f} G exponentials "
              f"{exp_ms:.4f} ms at {SFU_EXP_PER_CLK}/clock/SM x "
              f"{props.multi_processor_count} SMs x {clock / 1e9:.2f} GHz; "
              f"flops {flops_ms:.4f} ms), {100 * bound_ms / ms:.1f}% of "
              f"bound, max abs err {err:.3e} ({ratio:.3f} of its bound); "
              f"{clock_note}  [{card}]")
        print(f"[timing] mamba_scan on the model's inputs (the split's first "
              f"Mamba layer): {model_ms:.4f} ms, "
              f"{100 * bound_ms / model_ms:.1f}% of bound, max abs err "
              f"{errs['model'][0]:.3e} ({errs['model'][1]:.3f} of its bound); "
              f"{model_note}  [{card}]")
        d_model = cfg.d_model
        in_proj = (torch.randn((B * S, d_model), dtype=torch.bfloat16,
                               device=DEVICE),
                   torch.randn((d_model, 2 * di), dtype=torch.bfloat16,
                               device=DEVICE) * d_model ** -0.5)
        _b6_gap(card, sampler, {"grid inputs": args,
                                "model inputs": model_args}, in_proj)
    for label, (e, r) in errs.items():
        require(r <= 1.0, f"B6 timing, {label} inputs: error {r:.3f} of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                err=err)


# ----------------------------------------------------------------- phase 22
def arch_config(arch, dtype, periods=None):
    """``arch`` at its published widths (``LM_WIDTHS = "full"``; the
    registered SMOKE widths in a CPU rehearsal) in ``dtype``, cut to
    ``periods`` periods of its pattern (an encoder-decoder model's encoder
    too) where given, else to ``ARCH_PERIODS[arch]``, else whole."""
    base = (get_smoke_config(arch) if LM_WIDTHS == "smoke"
            else get_config(arch))
    cfg = dataclasses.replace(base, dtype=dtype)
    periods = ARCH_PERIODS.get(arch) if periods is None else periods
    if periods is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=periods * cfg.period,
            n_enc_layers=periods * cfg.period if cfg.enc_dec else 0)
    return cfg


def _no_drop(cfg):
    """An MoE model whose forward over ``DECODE_SEQ`` tokens and whose
    decode steps drop no token: capacity factor max(8, experts / top_k),
    so the capacity is at least T * top_k (8 alone gives llama4-maverick's
    128 experts a capacity of 4 for 64 tokens)."""
    if cfg.moe is None:
        return cfg
    cf = max(8.0, cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _sharpen_routers(model) -> None:
    """Router weights x ROUTER_SCALE, so near-tie expert choices cannot
    flip between two summation orders (as the CPU parity tests do)."""
    for name, w in model.named_parameters():
        if name.endswith("router"):
            w.mul_(ROUTER_SCALE)


def _is_xlstm(cfg) -> bool:
    return any(mix in ("mlstm", "slstm") for mix, _ in cfg.pattern)


def _frames(cfg, B, seed, device=None):
    """Stand-in frontend output for an encoder-decoder model: a seeded
    normal (B, WHISPER_FRAMES, d) in float32, as the JAX package's
    ``input_specs`` gives it."""
    dev = DEVICE if device is None else device
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=g,
                       device=dev)


def _prefill_batch(cfg, B, seed):
    """The prefill's inputs: whisper's WHISPER_FRAMES frames and
    WHISPER_FRAMES // dec_len_ratio decoder tokens, xLSTM's XLSTM_SEQ
    tokens, LM_SEQ tokens for the rest."""
    if cfg.enc_dec:
        S = WHISPER_FRAMES // cfg.dec_len_ratio
        return {"tokens": _tokens(cfg, B, S, seed),
                "enc_embeds": _frames(cfg, B, seed + 1)}
    return {"tokens": _tokens(cfg, B, XLSTM_SEQ if _is_xlstm(cfg)
                              else LM_SEQ, seed)}


def _elapsed(fn) -> float:
    """Seconds of one call of ``fn``: CUDA events on the card, the host
    clock in a CPU rehearsal.  The result is dropped."""
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return 1e-3 * start.elapsed_time(end)


def _reset_peak() -> None:
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else 0.0


def _mlstm_step_split(cfg, model, batch, card):
    """Whether the recurrent mLSTM is bound by its state traffic or by its
    launches: the first mLSTM layer's recurrence timed at B = LM_BATCH and
    B = 1, beside the bytes of the (B, H, dh, dh) float32 state that each
    step moves (five passes: read and write for the decay, read and
    write for the update, one read for q @ C) over 3.35 TB/s."""
    p = model.decoder[0]["l0_mix"]
    x = L.apply_norm(cfg.norm, p["norm"], L.embed_apply(model.embed,
                                                         batch["tokens"]))
    _, _, q, k, v, logi, logf = XL._mlstm_heads(p["mlstm"], x, cfg.xlstm,
                                                cfg.d_model)
    S, H, dh = q.shape[1], q.shape[2], q.shape[3]
    chunk = min(cfg.xlstm.chunk, S)
    out = {}
    for b in (q.shape[0], 1):
        secs = _elapsed(lambda: XL._mlstm_recurrent(
            q[:b], k[:b], v[:b], logi[:b], logf[:b], chunk))
        bound = 1e3 * 5 * b * H * dh * dh * 4 / HBM_BYTES_PER_S
        out[b] = 1e3 * secs / S
        print(f"[xlstm] one mLSTM layer's recurrence, B={b} S={S}: "
              f"{1e3 * secs:.1f} ms, {out[b]:.4f} ms a step; its state "
              f"traffic bounds a step at {bound:.4f} ms  [{card}]")
    big, one = out[q.shape[0]], out[1]
    verdict = "state traffic" if big > 2.0 * one else "launches"
    print(f"[xlstm] recurrent mLSTM: a step at B={q.shape[0]} takes "
          f"{big / one:.2f}x the time of one at B=1, so {verdict} dominate "
          f"(state traffic would scale with B)  [{card}]")
    return verdict


def _arch_decode_vs_forward(arch, card) -> float:
    """``arch`` in float32 at full width, one period (whisper: one encoder
    and one decoder period), B = 1: the logits of ``forward`` against
    those of ``DECODE_SEQ`` ``decode_step`` calls, within DECODE_TOL of
    max |logit| (as phase 19).  MoE models drop nothing (``_no_drop``)
    and route sharply (``_sharpen_routers``).  xLSTM is held to
    XLSTM_DECODE_TOL, and so are its chunkwise mLSTM's forward against the
    recurrent one, and the float32 forward and decode against a forward of
    the same weights with float64 projections."""
    cfg = _no_drop(arch_config(arch, torch.float32, periods=1))
    model = T.init_params(cfg, LM_SEED, DEVICE)
    _sharpen_routers(model)
    tokens = _tokens(cfg, 1, DECODE_SEQ, seed=3)
    batch, enc = {"tokens": tokens}, None
    if cfg.enc_dec:
        batch["enc_embeds"] = _frames(cfg, 1, seed=5)
        enc, _ = T.encode(cfg, model, batch["enc_embeds"])
    ref, _ = T.forward(cfg, model, batch)
    cache = T.init_cache(cfg, 1, DECODE_SEQ, DEVICE)
    outs = []
    for t in range(DECODE_SEQ):
        logits, cache = T.decode_step(cfg, model, cache, tokens[:, t:t + 1],
                                      t, enc)
        outs.append(logits[:, 0])
    err = rel_err(torch.stack(outs, dim=1), ref)
    tol, note = DECODE_TOL, ""
    if _is_xlstm(cfg):
        tol = XLSTM_DECODE_TOL
        cw = dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunkwise=True))
        cw_err = rel_err(T.forward(cw, model, batch)[0], ref)
        # the same seed draws the same weights; the gates and states stay
        # float32, as the model defines them
        c64 = dataclasses.replace(cfg, dtype=torch.float64)
        exact, _ = T.forward(c64, T.init_params(c64, LM_SEED, DEVICE), batch)
        f64 = (rel_err(ref, exact), rel_err(torch.stack(outs, dim=1), exact))
        note = (f"; chunkwise forward against recurrent {cw_err:.3e}; "
                f"against a forward with float64 projections: forward "
                f"{f64[0]:.3e}, decode {f64[1]:.3e}")
        require(max(cw_err, *f64) <= tol,
                f"{arch}: chunkwise or float64 check {max(cw_err, *f64):.3e}"
                f" > {tol}")
    cap = ""
    if cfg.moe is not None:
        cap = (f", capacity factor {cfg.moe.capacity_factor:g}, routers x"
               f"{ROUTER_SCALE:g}")
    print(f"[{arch}] f32, {cfg.n_layers} layers"
          f"{f' + {cfg.n_enc_layers} encoder' if cfg.enc_dec else ''}, B=1, "
          f"S={DECODE_SEQ}{cap}: max |decode - forward| {err:.3e} of max "
          f"|logit| (tol {tol}){note}  [{card}]")
    require(bool(torch.isfinite(ref).all()), f"{arch} f32: non-finite logits")
    require(err <= tol, f"{arch}: decode vs forward {err:.3e} > {tol}")
    return err


def _arch_card_vs_cpu(arch, card) -> float:
    """``arch``'s registered SMOKE config with weights from a seed:
    ``forward`` and 4 decode steps on the card against the port's CPU run
    of the same weights, within MOE_TOL of max |logit| (as phase 20;
    MoE models with capacity factor 8 and sharpened routers)."""
    base = get_smoke_config(arch)
    cfg = base if base.moe is None else dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    host = T.init_params(cfg, LM_SEED, "cpu")
    _sharpen_routers(host)
    card_model = copy.deepcopy(host).to(DEVICE)
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(4))
    batch = {"tokens": tok}
    if cfg.enc_dec:
        batch["enc_embeds"] = torch.randn(
            (2, 16, cfg.d_model), generator=torch.Generator().manual_seed(6))
    on_card = {k: v.to(DEVICE) for k, v in batch.items()}
    got, _ = T.forward(cfg, card_model, on_card)
    want, _ = T.forward(cfg, host, batch)
    err = rel_err(got.cpu(), want)
    enc_c = enc_h = None
    if cfg.enc_dec:
        enc_c = T.encode(cfg, card_model, on_card["enc_embeds"])[0]
        enc_h = T.encode(cfg, host, batch["enc_embeds"])[0]
    cd, hd = (T.init_cache(cfg, 2, 4, dev) for dev in (DEVICE, "cpu"))
    derr = 0.0
    for t in range(4):
        a, cd = T.decode_step(cfg, card_model, cd,
                              tok[:, t:t + 1].to(DEVICE), t, enc_c)
        b, hd = T.decode_step(cfg, host, hd, tok[:, t:t + 1], t, enc_h)
        derr = max(derr, rel_err(a.cpu(), b))
    print(f"[{arch}] SMOKE {cfg.name}: card against CPU, forward {err:.3e}, "
          f"4 decode steps {derr:.3e} of max |logit| (tol {MOE_TOL})  "
          f"[{card}]")
    require(err <= MOE_TOL and derr <= MOE_TOL,
            f"{arch}: card differs from CPU by {max(err, derr):.3e}")
    return max(err, derr)


def _free() -> None:
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_arch(arch, card):
    """Slice 8b's main path for one architecture: bfloat16 weights from a
    seed at its published widths (cut in depth by ``ARCH_PERIODS``), one
    prefill ``forward`` timed with CUDA events after a warm-up, then
    ``launch.serve.generate`` (SERVE_PROMPT prompt tokens, SERVE_GEN
    greedy ones, B = LM_BATCH; whisper with its encoder's states); then
    the float32 decode-vs-forward check and the card-vs-CPU check.  No
    kernel of the port is on these paths: the launch counts stay 0."""
    _free()
    cfg = arch_config(arch, torch.bfloat16)
    full = get_smoke_config(arch) if LM_WIDTHS == "smoke" else get_config(arch)
    t0 = time.perf_counter()
    model = T.init_params(cfg, LM_SEED, DEVICE)
    sync()
    init_s = time.perf_counter() - t0
    n_par, n_act = T.param_count(model), T.active_param_count(cfg, model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    depth = (f"{cfg.n_layers} of {full.n_layers} layers" if
             cfg.n_layers != full.n_layers else f"all {cfg.n_layers} layers")
    if cfg.enc_dec:
        depth += f" + {cfg.n_enc_layers} encoder layers"
    experts = (f" experts={cfg.moe.n_experts} top_k={cfg.moe.top_k}"
               if cfg.moe else "")
    print(f"[{arch}] d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"pattern={[f'{m}+{f}' for m, f in cfg.pattern]}{experts}"
          f", {depth}: {n_par / 1e9:.3f} G parameters ({n_act / 1e9:.3f} G "
          f"active), {nbytes / 1e9:.2f} GB, made from seed {LM_SEED} in "
          f"{init_s:.1f} s")

    batch = _prefill_batch(cfg, LM_BATCH, seed=1)
    B, S = batch["tokens"].shape
    execution.reset_launch_counts()
    _reset_peak()
    logits, _ = T.forward(cfg, model, batch)
    peak = _peak_gb()           # before the check, whose temporaries are
    finite = bool(torch.isfinite(logits).all())     # larger than the logits
    shape = tuple(logits.shape)
    del logits
    secs = _elapsed(lambda: T.forward(cfg, model, batch))
    launches = execution.launch_counts()
    frames = ""
    if cfg.enc_dec:
        frames = (f" + {WHISPER_FRAMES} frames a row "
                  f"({B * WHISPER_FRAMES / secs:.0f} frames/s)")
    print(f"[{arch}] prefill B={B} S={S}{frames}: {1e3 * secs:.1f} ms "
          f"({B * S / secs:.0f} tokens/s), logits {shape} finite={finite}, "
          f"kernel launches {dict(launches) or 'none'}  [{card}]")
    require(finite, f"{arch} prefill: non-finite logits")
    require(shape == (B, S, cfg.padded_vocab), f"{arch} prefill: {shape}")
    require(not any(launches.values()), f"{arch}: a kernel ran: {launches}")
    row = dict(arch=arch, depth=depth, params=n_par, active=n_act,
               gb=nbytes / 1e9, B=B, S=S, tokens_per_s=B * S / secs)
    if _is_xlstm(cfg):
        cw = dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunkwise=True))
        _elapsed(lambda: T.forward(cw, model, batch))
        cw_s = _elapsed(lambda: T.forward(cw, model, batch))
        print(f"[{arch}] chunkwise mLSTM (chunk {cfg.xlstm.chunk}) prefill "
              f"B={B} S={S}: {1e3 * cw_s:.1f} ms ({B * S / cw_s:.0f} "
              f"tokens/s) against the recurrent form's {1e3 * secs:.1f} ms  "
              f"[{card}]")
        row["mlstm_bound_by"] = _mlstm_step_split(cfg, model, batch, card)

    enc = None
    if cfg.enc_dec:
        enc, _ = T.encode(cfg, model, batch["enc_embeds"])
    del batch
    prompts = _tokens(cfg, LM_BATCH, SERVE_PROMPT, seed=2)
    _reset_peak()
    out = generate(cfg, model, prompts, SERVE_GEN, enc)
    toks = out.tokens
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    ms_step = 1e3 * out.decode_s / (SERVE_GEN - 1)
    peak = max(peak, _peak_gb())
    with_enc = " (the encoder's states)" if enc is not None else ""
    print(f"[{arch}] generate B={LM_BATCH} prompt={SERVE_PROMPT} "
          f"gen={SERVE_GEN}{with_enc}: {ms_step:.2f} ms a decode step "
          f"({LM_BATCH * (SERVE_GEN - 1) / out.decode_s:.1f} tokens/s), "
          f"prompt {1e3 * out.prefill_s / SERVE_PROMPT:.2f} ms a step, "
          f"tokens in the vocabulary: {in_vocab}, first "
          f"{toks[0, :8].tolist()}; peak memory {peak:.2f} GB  [{card}]")
    require(tuple(toks.shape) == (LM_BATCH, SERVE_GEN),
            f"{arch} serve: tokens {tuple(toks.shape)}")
    require(in_vocab, f"{arch} serve: a token outside the vocabulary")
    require(bool(torch.isfinite(out.logits).all()),
            f"{arch} serve: non-finite logits")
    row.update(ms_step=ms_step, peak_gb=peak)
    del model, out, enc, prompts, toks
    _free()
    row["f32_err"] = _arch_decode_vs_forward(arch, card)
    _free()
    row["card_cpu_err"] = _arch_card_vs_cpu(arch, card)
    return row


def print_arch_table(rows, card) -> None:
    print(f"[archs] slice 8b, bf16, weights from seed {LM_SEED}  [{card}]")
    for r in rows:
        print(f"[archs] {r['arch']:22s} {r['depth']:38s} "
              f"{r['params'] / 1e9:8.3f} G ({r['active'] / 1e9:7.3f} G "
              f"active) {r['gb']:6.2f} GB | prefill B={r['B']} S={r['S']} "
              f"{r['tokens_per_s']:9.0f} tokens/s | decode "
              f"{r['ms_step']:7.2f} ms/step | peak {r['peak_gb']:6.2f} GB | "
              f"f32 {r['f32_err']:.2e} | card/CPU {r['card_cpu_err']:.2e}")


# ----------------------------------------------------------------- phase 23
def _train_reckoning(cfg, tr) -> str:
    """The memory the full-width step should need, from its shapes:
    weights, gradients, float32 m and v, the float32 logits and their
    gradient, each period's saved input, one float32 temporary of the
    largest leaf."""
    n = sum(p.numel() for p in tr.params)
    wbytes = sum(p.numel() * p.element_size() for p in tr.params)
    logits = TRAIN_BATCH * TRAIN_SEQ * cfg.padded_vocab * 4
    saved = cfg.n_periods * TRAIN_BATCH * TRAIN_SEQ * cfg.d_model * 2
    temp = max(p.numel() for p in tr.params) * 4
    gb = [wbytes / 1e9, wbytes / 1e9, 8 * n / 1e9, 2 * logits / 1e9,
          saved / 1e9, temp / 1e9]
    return (f"weights {gb[0]:.2f} GB, gradients {gb[1]:.2f}, m and v "
            f"{gb[2]:.2f}, f32 logits and their gradient {gb[3]:.2f}, "
            f"saved period inputs {gb[4]:.2f}, one f32 temporary of the "
            f"largest leaf {gb[5]:.2f}: {sum(gb):.1f} GB before the "
            f"attention and optimizer temporaries")


#: the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_PEAK_FLOPS = 989e12
#: kernel name fragments -> the kind a train step's kernel is counted
#: under (the first that matches)
TRAIN_KERNEL_KINDS = (("gemm", "GEMMs"), ("nvjet", "GEMMs"),
                      ("xmma", "GEMMs"), ("cutlass", "GEMMs"),
                      ("reduce", "reductions"), ("Memcpy", "copies"),
                      ("Memset", "copies"), ("Copy", "copies"),
                      ("index", "index, gather, scatter"),
                      ("gather", "index, gather, scatter"),
                      ("scatter", "index, gather, scatter"),
                      ("elementwise", "elementwise"))


def _train_step_bound(cfg, tr):
    """The least time the card could take for one full-width step, the
    larger of two times: its products at the card's peak rates (bf16 on
    the tensor cores; the attention's float32 products outside them, as
    ``main`` turns TF32 off) and the bytes the update must move (bf16
    weights and gradients read, float32 m and v read and written, the
    weights written).  Products: each decoder weight's with every token
    four times (forward, remat's second forward, two in the backward),
    the tied LM head's three times, the attention's score and value
    products on the (query, KV) tiles that ``layers._online_attn``'s
    causal loop computes, four times.  Returns ``(ms, bound_by, text)``."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dec = sum(p.numel() for k, p in zip(tr.keys, tr.params)
              if k.startswith("decoder/") and p.ndim >= 3)
    bf16 = 2 * tokens * (4 * dec + 3 * cfg.d_model * cfg.padded_vocab)
    S = TRAIN_SEQ
    qb = min(S, inspect.signature(
        L._online_attn).parameters["q_block"].default)
    kvb = min(S, inspect.signature(
        L.attention_apply).parameters["kv_block"].default)
    tiles = sum(min(-(-S // kvb), (q0 + qb - 1) // kvb + 1)
                for q0 in range(0, S, qb))
    n_attn = cfg.n_periods * sum(m == "attn" for m, _ in cfg.pattern)
    f32 = (4 * n_attn * 4 * TRAIN_BATCH * cfg.n_heads * cfg.hd * qb * kvb
           * tiles)
    ops_ms = 1e3 * (bf16 / BF16_PEAK_FLOPS
                    + f32 / PEAK_FLOPS[torch.float32])
    nbytes = sum(p.numel() * (3 * p.element_size() + 16) for p in tr.params)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    text = (f"bf16 products {bf16 / 1e12:.2f} TFLOP at "
            f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s plus float32 attention "
            f"products {f32 / 1e12:.2f} TFLOP ({tiles} of "
            f"{(S // qb) * (-(-S // kvb))} tiles) at "
            f"{PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s: {ops_ms:.1f} "
            f"ms; the update's {nbytes / 1e9:.1f} GB at 3.35 TB/s: "
            f"{bytes_ms:.1f} ms")
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", text
    return bytes_ms, "bytes", text


def _train_profile(tr, batch, step, card):
    """One more train step under ``torch.profiler``: the card's busy and
    idle time in its window, device time by kind of kernel and the
    kernels that took the most (the card only)."""
    if DEVICE != "cuda":
        return None
    split = _device_split(lambda: tr.train_step(batch, step), 1,
                          TRAIN_KERNEL_KINDS)
    if split is None:
        print(f"[train] profiler split: not measured (the profiler saw no "
              f"kernel)  [{card}]")
        return None
    kinds = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
        split["kinds"].items(), key=lambda kv: -kv[1]))
    top = ", ".join(f"{k[:60]} {v:.1f}" for k, v in sorted(
        split["names"].items(), key=lambda kv: -kv[1])[:8])
    print(f"[train] profiler split of one step: {split['wall']:.1f} ms wall, "
          f"the card busy {split['busy']:.1f} ms and idle {split['idle']:.1f}"
          f" ms ({100 * split['idle_share']:.1f}% of its window); device ms "
          f"by kind: {kinds}; the most device time: {top}  [{card}]")
    return split


def _sample(t: torch.Tensor) -> torch.Tensor:
    """Up to 65,536 evenly strided entries of ``t``, copied."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // 65536)].clone()


def _train_full_width(card):
    """The full-width train step: ``Trainer.train_step`` on llama3.2-3b in
    bf16, B TRAIN_BATCH x S TRAIN_SEQ, TRAIN_WARM untimed and TRAIN_STEPS
    timed steps, the two halves of each timed with CUDA events."""
    cfg = arch_config(TRAIN_ARCH, torch.bfloat16)
    n = TRAIN_WARM + TRAIN_STEPS
    tc = TrainConfig(lr=TRAIN_LR, warmup=n, total_steps=n, seed=LM_SEED)
    tr = Trainer(cfg, tc, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                 device=DEVICE)
    t0 = time.perf_counter()
    tr.init_state()
    sync()
    print(f"[train] {TRAIN_ARCH} d={cfg.d_model} layers={cfg.n_layers} "
          f"vocab={cfg.vocab_size}: {T.param_count(tr.model) / 1e9:.3f} G "
          f"parameters, bf16 with float32 AdamW state, per-period remat, "
          f"state made in {time.perf_counter() - t0:.1f} s; reckoning: "
          f"{_train_reckoning(cfg, tr)}  [{card}]")
    before = [_sample(p) for p in tr.params]
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=LM_SEED)
    batches = [to_device(data.batch(i), DEVICE) for i in range(n)]
    execution.reset_launch_counts()
    _reset_peak()
    rows = []
    for step, batch in enumerate(batches):
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if DEVICE == "cuda" else None)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        loss, metrics, grads = tr.compute_grads(batch)
        if ev:
            ev[1].record()
        t1 = time.perf_counter()
        gnorm, lr = tr.apply_grads(grads, step)
        del grads
        if ev:
            ev[2].record()
            ev[2].synchronize()
            fb, up = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        else:
            fb = 1e3 * (t1 - t0)
            up = 1e3 * (time.perf_counter() - t1)
        rows.append(dict(loss=float(loss), gnorm=float(gnorm), lr=lr,
                         fb=fb, up=up))
    peak = _peak_gb()
    launches = execution.launch_counts()
    split = _train_profile(tr, batches[-1], n, card)
    moved = [not torch.equal(b, _sample(p))
             for b, p in zip(before, tr.params)]
    timed_rows = rows[TRAIN_WARM:]
    ms = [r["fb"] + r["up"] for r in timed_rows]
    fb = sum(r["fb"] for r in timed_rows) / len(timed_rows)
    up = sum(r["up"] for r in timed_rows) / len(timed_rows)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mean_ms = sum(ms) / len(ms)
    bound_ms, bound_by, bound_text = _train_step_bound(cfg, tr)
    print(f"[train] step bound: {bound_text}: {bound_ms:.1f} ms, by "
          f"{bound_by}; the timed steps' mean at "
          f"{100 * bound_ms / mean_ms:.1f}% of it  [{card}]")
    first, last = rows[0], rows[-1]
    print(f"[train] {TRAIN_ARCH} B={TRAIN_BATCH} S={TRAIN_SEQ} "
          f"({tokens} tokens a step), {len(timed_rows)} timed steps after "
          f"{TRAIN_WARM}: {mean_ms:.1f} ms a step (min {min(ms):.1f}, max "
          f"{max(ms):.1f}), {1e3 * tokens / mean_ms:.0f} tokens/s; forward+"
          f"backward {fb:.1f} ms, clip+update {up:.1f} ms; peak memory "
          f"{peak:.2f} GB; loss {first['loss']:.4f} -> {last['loss']:.4f}, "
          f"gnorm {first['gnorm']:.4f} -> {last['gnorm']:.4f}, lr "
          f"{first['lr']:.3g} -> {last['lr']:.3g}; leaves moved "
          f"{sum(moved)}/{len(moved)}; kernel launches "
          f"{dict(launches) or 'none'}  [{card}]")
    require(all(np.isfinite([r["loss"], r["gnorm"]]).all() for r in rows),
            "train: a non-finite loss or gnorm")
    require(all(r["gnorm"] > 0 for r in rows), "train: gnorm 0")
    require(all(moved), f"train: {len(moved) - sum(moved)} leaves did not "
            f"move")
    require(not any(launches.values()), f"train: a kernel ran: {launches}")
    out = dict(ms=mean_ms, tokens_per_s=1e3 * tokens / mean_ms, fb_ms=fb,
               update_ms=up, peak_gb=peak, first=first, last=last,
               bound_ms=bound_ms, split=split)
    del tr, batches, before
    _free()
    return out


def _grads_card_vs_cpu(cfg, batch):
    """One ``compute_grads`` of the same weights and batch on the card and
    on the CPU: ``(loss error, worst leaf error, worst leaf, trainers)``,
    each gradient leaf against its largest CPU entry.  The weights come
    from ``init_params`` on the CPU (MoE routers sharpened) and a copy of
    them on the card; each trainer stacks its own model."""
    host = T.init_params(cfg, LM_SEED, "cpu")
    _sharpen_routers(host)
    models = {"cpu": host, DEVICE: copy.deepcopy(host).to(DEVICE)}
    res, trainers = {}, {}
    for dev, model in models.items():
        tr = Trainer(cfg, TrainConfig(lr=TRAIN_LR, warmup=0), seq_len=16,
                     global_batch=2, device=dev,
                     init_model=lambda model=model: model)
        tr.init_state()
        loss, _, grads = tr.compute_grads(
            {k: v.to(dev) for k, v in batch.items()})
        # copies: ``apply_grads`` clips the gradients in place, and on the
        # CPU ``.to("cpu")`` alone would return the very same tensors
        res[dev] = (loss.to("cpu", copy=True),
                    [g.to("cpu", copy=True) for g in grads])
        trainers[dev] = (tr, grads)
    lerr = rel_err(res[DEVICE][0], res["cpu"][0])
    gerr, worst = max((rel_err(a, b), k) for a, b, k in zip(
        res[DEVICE][1], res["cpu"][1], tr.keys))
    return lerr, gerr, worst, trainers


def _train_full_width_f32(card) -> float:
    """llama3.2-3b at its published widths cut to 2 layers, in float32, B
    1 x S TRAIN_SEQ: the gradients on the card against the CPU's, within
    FULL_GRAD_TOL (several attention blocks, the 128,256-row embedding's
    backward)."""
    cfg = arch_config(TRAIN_ARCH, torch.float32, periods=2)
    batch = to_device(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, 1,
                                  seed=LM_SEED).batch(0), "cpu")
    t0 = time.perf_counter()
    lerr, gerr, worst, _ = _grads_card_vs_cpu(cfg, batch)
    print(f"[train] {TRAIN_ARCH} at published widths, {cfg.n_layers} "
          f"layers, f32, B=1 S={TRAIN_SEQ}: gradients on the card against "
          f"the CPU, loss {lerr:.3e}, worst leaf {gerr:.3e} of its largest "
          f"entry ({worst}; tol {FULL_GRAD_TOL}), "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    require(lerr <= 1e-5 and gerr <= FULL_GRAD_TOL,
            f"train f32 full width: card differs from CPU: loss "
            f"{lerr:.3e}, gradients {gerr:.3e}")
    _free()
    return gerr


def _smoke_train_batch(cfg, device):
    b = to_device(SyntheticLM(cfg.vocab_size, 16, 2, seed=LM_SEED).batch(0),
                  device)
    if cfg.enc_dec:
        b["enc_embeds"] = torch.randn(
            (2, 24, cfg.d_model),
            generator=torch.Generator().manual_seed(6)).to(device)
    return b


def _train_card_vs_cpu(arch, card) -> float:
    """One train step of ``arch``'s SMOKE config on the card and on the
    CPU from the same weights and batch: the loss and every gradient leaf
    within TRAIN_GRAD_TOLS.get(arch, TRAIN_GRAD_TOL) of its largest CPU
    entry.  MoE
    models with capacity factor 8 and sharpened routers, as phase 22."""
    base = get_smoke_config(arch)
    cfg = base if base.moe is None else dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    lerr, gerr, worst, trainers = _grads_card_vs_cpu(
        cfg, _smoke_train_batch(cfg, "cpu"))
    gnorms = []
    for tr, grads in trainers.values():
        gnorm, _ = tr.apply_grads(grads, 1)
        require(bool(torch.isfinite(gnorm)), f"{arch}: non-finite gnorm")
        gnorms.append(float(gnorm))
    tol = TRAIN_GRAD_TOLS.get(arch, TRAIN_GRAD_TOL)
    print(f"[train] SMOKE {cfg.name}: one step on the card against the "
          f"CPU, loss {lerr:.3e}, worst gradient leaf {gerr:.3e} of its "
          f"largest entry ({worst}; tol {tol}); gnorm before clipping "
          f"{' / '.join(f'{g:.4f}' for g in gnorms)}  [{card}]")
    require(lerr <= 1e-5 and gerr <= tol,
            f"{arch}: card train step differs from CPU: loss {lerr:.3e}, "
            f"gradients {gerr:.3e}")
    return gerr


def _train_resume(card):
    """Kill and restart on the card: SMOKE llama3.2-3b in float32, run A
    trains 6 steps saving at step 3; a fresh trainer restores step 3 (its
    state equal to the checkpoint bit for bit) and trains steps 4-6: the
    first loss equal to run A's bit for bit (the dense forward uses no
    atomics), the next two within RESUME_TOL (the embedding's backward
    does)."""
    cfg = get_smoke_config(TRAIN_ARCH)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(path):
        tc = TrainConfig(lr=1e-3, warmup=2, total_steps=6,
                         ckpt_dir=str(path), ckpt_every=3, log_every=100)
        return Trainer(cfg, tc, seq_len=32, global_batch=4, device=DEVICE)

    run_a = trainer(root / "a").fit(6, log=lambda *_: None)["losses"]
    (root / "b").mkdir(parents=True)
    shutil.copytree(root / "a" / "step_3", root / "b" / "step_3")
    check = trainer(root / "b")
    check.init_state()
    restored, step = check.ckpt.resume(check.state_tree())
    check.load_state_tree(restored)
    saved, _ = restore_checkpoint(str(root / "b"), 3, check.state_tree())
    live, saved = flatten(check.state_tree()), flatten(saved)
    same = live.keys() == saved.keys() and all(
        to_numpy(live[k]).tobytes() == to_numpy(saved[k]).tobytes()
        for k in live)
    run_b = trainer(root / "b").fit(6, log=lambda *_: None)["losses"]
    rest = max(abs(a - b) / abs(b) for a, b in zip(run_b[1:], run_a[4:]))
    print(f"[train] kill and restart on the card (SMOKE {cfg.name}, f32): "
          f"run A losses {[f'{x:.6f}' for x in run_a]}; resumed at step "
          f"{step}: state equal to the checkpoint bit for bit: {same}; "
          f"step 4 loss {run_b[0]!r} against {run_a[3]!r}; steps 5-6 "
          f"within {rest:.3e} (tol {RESUME_TOL})  [{card}]")
    require(step == 3 and same, "resume: restored state != checkpoint")
    require(len(run_b) == 3 and run_b[0] == run_a[3],
            f"resume: step 4 loss {run_b[0]!r} != {run_a[3]!r}")
    require(rest <= RESUME_TOL, f"resume: steps 5-6 differ by {rest:.3e}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(step4=run_b[0], rest=rest)


def phase_train(card):
    """Slice 11's main path: the full-width train step, its gradients in
    float32 at 2 layers on the card against the CPU, the SMOKE train step
    of every architecture on the card against the CPU, and kill and
    restart on the card."""
    _free()
    out = _train_full_width(card)
    out["f32_card_cpu"] = _train_full_width_f32(card)
    out["card_cpu"] = {arch: _train_card_vs_cpu(arch, card)
                       for arch in list_archs()}
    out["resume"] = _train_resume(card)
    return out


def _dryrun_profile(arch, shape, card):
    """One more run of a measured cell's step under ``torch.profiler``:
    the card's busy and idle time and device time by kind of kernel."""
    sp = SHAPES[shape]
    full = get_config(arch)
    cut = ShapeSpec(shape, sp.seq_len,
                    max(1, sp.global_batch // DR.MEASURE_DEVICES), sp.kind)
    opt = DR.pick_optimizer(T.param_count(T.init_params(full,
                                                         device="meta")))
    fn, _ = DR._step_fn(DR.one_period(full), cut, opt, torch.device("cuda"),
                        0)
    fn()
    split = _device_split(fn, 1, TRAIN_KERNEL_KINDS)
    del fn
    _free()
    if split is None:
        print(f"[dryrun] {arch} x {shape} profiler split: not measured (the "
              f"profiler saw no kernel)  [{card}]")
        return
    kinds = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
        split["kinds"].items(), key=lambda kv: -kv[1]))
    top = ", ".join(f"{k[:50]} {v:.1f}" for k, v in sorted(
        split["names"].items(), key=lambda kv: -kv[1])[:5])
    print(f"[dryrun] {arch} x {shape} profiler split of one run: "
          f"{split['wall']:.1f} ms wall, the card busy {split['busy']:.1f} ms "
          f"and idle {split['idle']:.1f} ms ({100 * split['idle_share']:.1f}% "
          f"of its window); device ms by kind: {kinds}; the most device "
          f"time: {top}  [{card}]")


def phase_dryrun(card):
    """Slice 12's main path: the structural dry run of every cell, then the
    measured pass of ``DRYRUN_MEASURED`` on the card (a CPU rehearsal
    stops after the structural pass: the measured one needs the card)."""
    _free()
    out = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    DR.OUT_DIR = str(out)
    mesh = make_mesh("single")
    cells = dryrun_cells()
    t0 = time.perf_counter()
    for arch, shape in cells:
        r = DR.run_cell(arch, shape, mesh, "single", verbose=False)
        require(r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
                and r["memory"]["argument_size_in_bytes"] > 0,
                f"dry run {arch} x {shape}: empty terms")
    require(len(roofline.load("single")) == len(cells) == 32,
            f"dry run: {len(cells)} cells")
    print(f"[dryrun] structural pass: {len(cells)} cells in "
          f"{time.perf_counter() - t0:.1f} s (meta models, per-device "
          f"argument bytes, analytic cost with the H100 table)")
    if DEVICE != "cuda":
        print("[dryrun] measured pass: needs the card (CPU rehearsal)")
        shutil.rmtree(out)
        return {}
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    execution.reset_launch_counts()
    blocks = {}
    for arch, shape in DRYRUN_MEASURED:
        m = DR.run_cell(arch, shape, mesh, "single", verbose=False,
                        measure=True)["measured"]
        blocks[(arch, shape)] = m
        _free()
        if (arch, shape) in DRYRUN_NO_FIT:
            require(m["fits"] is False and "ms" not in m,
                    f"dry run {arch} x {shape} should not fit: {m}")
            print(f"[dryrun] {arch} x {shape}: does not fit: {m['reason']} "
                  f"(t_compute {m['t_compute'] * 1e3:.2f} ms, t_memory "
                  f"{m['t_memory'] * 1e3:.2f} ms)  [{card}]")
            continue
        require(m["fits"] and m["runs"] >= 1, f"dry run {arch} x {shape}: {m}")
        over = m["measured_fraction"] > FRACTION_MAX
        print(f"[dryrun] {arch} x {shape}: B {m['B_card']} x S "
              f"{m['seq_len']}, 1 period ({m['n_layers']} layers): "
              f"{m['ms']:.3f} ms median of {m['runs']} (warm-up "
              f"{m['warmup_ms']:.1f} ms), peak {m['peak_bytes'] / 1e9:.3f} "
              f"GB (arguments {m['argument_bytes'] / 1e9:.3f}, temporaries "
              f"{m['temp_bytes'] / 1e9:.3f}); t_compute "
              f"{m['t_compute'] * 1e3:.3f} ms, t_memory "
              f"{m['t_memory'] * 1e3:.3f} ms; compute_fraction "
              f"{m['compute_fraction']:.4f}, measured_fraction "
              f"{m['measured_fraction']:.4f}"
              f"{' (above 1.05: the analytic bytes overcount)' if over else ''}"
              f"  [{card}]")
        require(0 < m["compute_fraction"] <= FRACTION_MAX,
                f"dry run {arch} x {shape}: compute_fraction "
                f"{m['compute_fraction']}")
        require(m["peak_bytes"] <= card_bytes,
                f"dry run {arch} x {shape}: peak {m['peak_bytes']}")
    launches = execution.launch_counts()
    print(f"[dryrun] launches on the measured paths: {launches}")
    require(not any(launches.values()), "a kernel on the dry run's paths")
    for arch, shape in DRYRUN_PROFILED:
        _dryrun_profile(arch, shape, card)
    print(roofline.table(roofline.load("single")))
    shutil.rmtree(out)
    return blocks


# ----------------------------------------------------------------- phase 25
def _all(obj):
    """``obj`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _same_on_all(obj, what) -> None:
    got = _all(obj)
    require(all(g == got[0] for g in got),
            f"mesh: {what} differs between ranks: {got}")


def _mesh_psum(rank, dev, say, card):
    """(a) ``compressed_psum`` on the ranks' tensors: int8 equal to the
    int32 sum of the inputs quantised with the group's scale (computed
    from the all-gathered inputs) and within world * scale / 2 of the
    float64 sum; bf16 within 2^-6 of the sum of |x|; ms of each beside a
    float32 all-reduce of the same tensor."""
    world = dist.get_world_size()
    g = torch.Generator(device=dev).manual_seed(LM_SEED + rank)
    x = torch.randn(MESH_PSUM_N, generator=g, device=dev) * (0.5 + rank)
    y8, y16 = compressed_psum(x, bits=8), compressed_psum(x, bits=16)
    allx = x.new_empty(world * MESH_PSUM_N)
    dist.all_gather_into_tensor(allx, x)
    allx = allx.view(world, MESH_PSUM_N)
    scale = max(torch.max(torch.abs(r)) / 127.0 + 1e-12 for r in allx)
    q = torch.clamp(torch.round(allx / scale), -127, 127).to(torch.int32)
    want8 = q.sum(0).float() * scale
    exact = allx.double().sum(0)
    err8 = float((y8.double() - exact).abs().max())
    bound8 = world * float(scale) / 2 + 2.0 ** -23 * float(exact.abs().max())
    err16 = float(((y16.double() - exact).abs()
                   / allx.double().abs().sum(0)).max())
    require(torch.equal(y8, want8), "compressed_psum int8 != the int32 sum "
            "of the quantised inputs")
    require(err8 <= bound8, f"compressed_psum int8: {err8} > {bound8}")
    require(err16 <= 2.0 ** -6, f"compressed_psum bf16: {err16} of sum|x|")

    def ms(fn):
        t = []
        for _ in range(5):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            sync()
            t.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(t))

    f32 = ms(lambda: dist.all_reduce(x.clone()))
    t8, t16 = (ms(lambda b=b: compressed_psum(x, bits=b)) for b in (8, 16))
    say(f"[mesh] compressed_psum of {MESH_PSUM_N} float32 a rank on "
        f"{world} ranks ({x.device}): int8 equal to the int32 sum of the "
        f"quantised inputs on every rank, {err8:.3e} from the float64 sum "
        f"(bound world * scale / 2 = {bound8:.3e}); bf16 {err16:.3e} of "
        f"sum |x| (tol 2^-6); ms median of 5 (host clock): int8 {t8:.2f}, "
        f"bf16 {t16:.2f}, float32 all_reduce {f32:.2f}  [{card}]")
    return dict(err8=err8, err16=err16, int8_ms=t8, bf16_ms=t16, f32_ms=f32)


def _mesh_cfg(arch, cf=8.0):
    """``arch``'s SMOKE config with an MoE capacity factor ``cf`` (8 drops
    no token; ``None`` keeps the config's own)."""
    base = get_smoke_config(arch)
    return base if base.moe is None or cf is None else dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=cf))


def _mesh_trainer(arch, mesh, dev, arrays, root, every=100, layout="tp",
                  cf=8.0):
    SH.set_layout(layout)
    cfg = _mesh_cfg(arch, cf)
    tc = TrainConfig(lr=1e-3, warmup=2, total_steps=10, ckpt_dir=str(root),
                     ckpt_every=every, log_every=100)
    return Trainer(cfg, tc, mesh, seq_len=16, global_batch=4, device=dev,
                   init_model=lambda: model_from_arrays(cfg, arrays, dev))


def _mesh_steps(tr, steps):
    """``steps`` steps from 0: losses, and after each step this rank's
    float64 sum of its full parameters, held equal on every rank."""
    tr.init_state()
    data = SyntheticLM(tr.cfg.vocab_size, 16, 4, seed=LM_SEED)
    losses = []
    for s in range(steps):
        losses.append(float(tr.train_step(tr.local_batch(data.batch(s)),
                                          s)["loss"]))
        if tr.mesh is not None:
            _same_on_all(float(sum(p.double().sum() for p in tr.params)),
                         f"{tr.cfg.name} checksum after step {s}")
    return losses


def _rel_dist(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mesh_smoke(rank, dev, say, root, card):
    """(b) The SMOKE configs in float32 on (2, 2) under each layout
    against one device on the card and on the CPU (an MoE config at its
    own capacity factor too, whose drops must differ from none); resume
    on (2, 2); save on (2, 2), resume on (4, 1) and on one device."""
    m22 = make_host_mesh(2, 2, device=dev)
    m41 = make_host_mesh(4, 1, device=dev)
    out, one = {}, {}
    for arch, cf in MESH_RUNS:
        host = T.init_params(_mesh_cfg(arch, cf), LM_SEED, "cpu")
        _sharpen_routers(host)
        arrays = arrays_from_model(host)
        ref = {d: _mesh_steps(_mesh_trainer(arch, None, d, arrays, root,
                                            cf=cf), MESH_STEPS)
               for d in (dev, "cpu")}
        one[(arch, cf)] = ref[dev]
        what = f"{arch} capacity factor {cf or 'own'}"
        for layout in ("tp", "fsdp", "zero1"):
            got = _mesh_steps(_mesh_trainer(arch, m22, dev, arrays, root,
                                            layout=layout, cf=cf), MESH_STEPS)
            _same_on_all(got, f"{what} {layout} losses")
            e_card, e_cpu = _rel_dist(got, ref[dev]), _rel_dist(got,
                                                                ref["cpu"])
            say(f"[mesh] SMOKE {what} f32 (2, 2) {layout}: losses "
                f"{[f'{x:.6f}' for x in got]}, against one device on "
                f"{dev.type} {e_card:.2e}, on the CPU {e_cpu:.2e} (tol "
                f"{MESH_LOSS_TOL}, relative)  [{card}]")
            require(max(e_card, e_cpu) <= MESH_LOSS_TOL,
                    f"mesh {what} {layout}: {e_card:.2e} / {e_cpu:.2e}")
            out[(arch, cf, layout)] = (e_card, e_cpu)
    for arch, cf in MESH_RUNS:
        if cf is None:
            drops = _rel_dist(one[(arch, cf)], one[(arch, 8.0)])
            say(f"[mesh] SMOKE {arch}: one device's losses at its own "
                f"capacity factor {drops:.2e} from those at 8 (tokens "
                f"dropped; must exceed {10 * MESH_LOSS_TOL})  [{card}]")
            require(drops > 10 * MESH_LOSS_TOL,
                    f"mesh {arch}: the own capacity drops nothing")
    SH.set_layout("tp")
    arch = MESH_RUNS[0][0]
    host = T.init_params(_mesh_cfg(arch), LM_SEED, "cpu")
    arrays = arrays_from_model(host)
    quiet = dict(log=lambda *a: None)
    run_a = _mesh_trainer(arch, m22, dev, arrays, root / "a", 2).fit(
        6, **quiet)["losses"]
    world = dist.get_world_size()
    if rank == 0:
        shutil.copytree(root / "a" / "step_2", root / "b" / "step_2")
        for d in ["c"] + [f"one{r}" for r in range(world)]:
            shutil.copytree(root / "a" / "step_4", root / d / "step_4")
    dist.barrier()
    check = _mesh_trainer(arch, m22, dev, arrays, root / "b", 2)
    step = check.restore()
    live = check.state_tree()
    saved, _ = restore_checkpoint(str(root / "b"), step, live)
    live, saved = flatten(live), flatten(saved)
    same = step == 2 and live.keys() == saved.keys() and all(
        to_numpy(live[k]).tobytes() == to_numpy(saved[k]).tobytes()
        for k in saved)
    run_b = _mesh_trainer(arch, m22, dev, arrays, root / "b", 2).fit(
        4, **quiet)["losses"]
    rest = _rel_dist(run_b[1:], run_a[3:4])
    on41 = _mesh_trainer(arch, m41, dev, arrays, root / "c").fit(
        6, **quiet)["losses"]
    one_losses = _mesh_trainer(arch, None, dev, arrays,
                               root / f"one{rank}").fit(6, **quiet)["losses"]
    e41, e1 = _rel_dist(on41, run_a[4:]), _rel_dist(one_losses, run_a[4:])
    say(f"[mesh] SMOKE {arch} f32 on (2, 2), saving at steps 2 and 4: "
        f"losses {[f'{x:.6f}' for x in run_a]}; step 2 restored on (2, 2): "
        f"state equal to the checkpoint bit for bit: {same}; step 3 loss "
        f"{run_b[0]!r} against {run_a[2]!r}, step 4 within {rest:.2e} (tol "
        f"{RESUME_TOL}); step 4 resumed on (4, 1): steps 5-6 within "
        f"{e41:.2e} of the (2, 2) run's, on one device {e1:.2e} (tol "
        f"{MESH_LOSS_TOL})  [{card}]")
    require(same, "mesh resume: restored state != checkpoint")
    require(run_b[0] == run_a[2], f"mesh resume: {run_b[0]!r} != "
            f"{run_a[2]!r}")
    require(rest <= RESUME_TOL, f"mesh resume: step 4 {rest:.2e}")
    require(max(e41, e1) <= MESH_LOSS_TOL,
            f"mesh elastic restore: {e41:.2e} / {e1:.2e}")
    out["elastic"] = (e41, e1)
    return out


def _mesh_split(step):
    """One step under ``torch.profiler`` (CPU and card): the wall time
    split into collectives (host time inside c10d calls, and NCCL
    kernels), compute (the card busy outside them) and idle (the rest),
    in ms.  None if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        sync()
        wall = 1e3 * (time.perf_counter() - t0)
    coll_names = ("all_reduce", "allreduce", "all_gather", "allgather",
                  "c10d::", "gloo:", "nccl:", "barrier")
    coll, busy = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (coll if "nccl" in e.name.lower() else busy).append(span)
        elif any(n in e.name for n in coll_names):
            coll.append(span)
    if not busy:
        return None

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    coll = union(coll)
    coll_us = sum(b - a for a, b in coll)
    busy_us = sum(b - a for a, b in union(busy))
    inside = sum(max(0.0, min(b, d) - max(a, c))
                 for a, b in union(busy) for c, d in coll)
    compute = (busy_us - inside) * 1e-3
    return dict(wall=wall, collectives=coll_us * 1e-3, compute=compute,
                idle=max(0.0, wall - coll_us * 1e-3 - compute),
                device_busy=busy_us * 1e-3)


def _mesh_full(rank, dev, say, root, card):
    """(c) TRAIN_ARCH at its published widths cut to MESH_FULL_PERIODS
    periods, bf16 with float32 AdamW, on (2, 2) under ``tp``."""
    world = dist.get_world_size()
    SH.set_layout("tp")
    cfg = arch_config(TRAIN_ARCH, torch.bfloat16, periods=MESH_FULL_PERIODS)
    m22 = make_host_mesh(2, 2, device=dev)
    n = MESH_FULL_WARM + MESH_FULL_TIMED + 1 + MESH_FULL_NEXT

    def trainer(mesh):
        tc = TrainConfig(lr=TRAIN_LR, warmup=n, total_steps=n, seed=LM_SEED,
                         ckpt_dir=str(root / "full"), ckpt_every=1000,
                         log_every=1000)
        return Trainer(cfg, tc, mesh, seq_len=MESH_FULL_SEQ,
                       global_batch=MESH_FULL_BATCH, device=dev)

    tr = trainer(m22)
    t0 = time.perf_counter()
    tr.init_state()
    sync()
    made = time.perf_counter() - t0
    data = SyntheticLM(cfg.vocab_size, MESH_FULL_SEQ, MESH_FULL_BATCH,
                       seed=LM_SEED)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    execution.reset_launch_counts()
    ms, losses = [], []
    for step in range(MESH_FULL_WARM + MESH_FULL_TIMED):
        b = tr.local_batch(data.batch(step))
        dist.barrier()
        t0 = time.perf_counter()
        m = tr.train_step(b, step)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    launches = execution.launch_counts()
    step = MESH_FULL_WARM + MESH_FULL_TIMED
    b = tr.local_batch(data.batch(step))
    dist.barrier()
    if rank == 0 and DEVICE == "cuda":
        split = _mesh_split(lambda: tr.train_step(b, step))
    else:
        split = None
        tr.train_step(b, step)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if DEVICE == "cuda"
            else 0.0)
    # a rank holds the full parameters (the forward needs them), their
    # full gradient during a step, and its shards of the AdamW slots
    full_p = sum(p.numel() * p.element_size() for p in tr.params)
    held_o = sum(t.numel() * t.element_size()
                 for t in tr.opt_leaves().values())
    want_o = SH.shard_bytes(tr.opt_leaves(full=True), tr.ospecs, tr.view)
    full_o = sum(t.numel() * t.element_size()
                 for t in tr.opt_leaves(full=True).values())
    _same_on_all(float(sum(p.double().sum() for p in tr.params)),
                 "full-width checksum")
    per_rank = _all(dict(device=str(dev), peak=peak, held_o=held_o,
                         want_o=want_o))
    timed_ms = ms[MESH_FULL_WARM:]
    med = float(np.median(timed_ms))
    tokens = MESH_FULL_BATCH * MESH_FULL_SEQ
    say(f"[mesh] {TRAIN_ARCH} at published widths (d={cfg.d_model}, "
        f"{cfg.n_layers} layers, vocab {cfg.vocab_size}), bf16 with float32 "
        f"AdamW, (2, 2) tp on {world} ranks, global batch {MESH_FULL_BATCH}"
        f" x S {MESH_FULL_SEQ}: state made in {made:.1f} s; {med:.1f} ms a "
        f"step (median of {len(timed_ms)} after {MESH_FULL_WARM} warm-up: "
        f"{', '.join(f'{x:.1f}' for x in timed_ms)}; warm-up "
        f"{ms[0]:.1f}), {1e3 * tokens / med:.0f} tokens/s; losses "
        f"{[f'{x:.4f}' for x in losses]}; kernel launches "
        f"{dict(launches) or 'none'}  [{card}]")
    for r, pr in enumerate(per_rank):
        say(f"[mesh] rank {r} on {pr['device']}: peak {pr['peak']:.2f} GB; "
            f"holds the full parameters {full_p / 1e9:.3f} GB, their full "
            f"gradient {full_p / 1e9:.3f} GB during a step, and AdamW slot "
            f"shards {pr['held_o'] / 1e9:.3f} GB (placement: shard_bytes "
            f"{pr['want_o'] / 1e9:.3f}; the full state {full_o / 1e9:.3f})"
            f"  [{card}]")
        require(pr["held_o"] == pr["want_o"] < full_o,
                f"mesh: rank {r}'s slot shards are not shard_bytes: {pr}")
    if split is not None:
        say(f"[mesh] profiler split of one (2, 2) step on rank 0: "
            f"{split['wall']:.1f} ms wall: collectives {split['collectives']:.1f}"
            f" ms, compute {split['compute']:.1f} ms (the card busy "
            f"{split['device_busy']:.1f} ms in all), idle {split['idle']:.1f} "
            f"ms  [{card}]")
    require(all(np.isfinite(losses)), f"mesh full width: losses {losses}")
    require(not any(launches.values()), f"mesh: a kernel ran: {launches}")
    tr.ckpt.maybe_save(step + 1, tr.state_tree, force=True)
    straight = []
    for s in range(step + 1, step + 1 + MESH_FULL_NEXT):
        straight.append(float(tr.train_step(
            tr.local_batch(data.batch(s)), s)["loss"]))
    del tr, b
    _free()
    m41 = make_host_mesh(4, 1, device=dev)
    tr = trainer(m41)
    at = tr.restore()
    require(at == step + 1, f"mesh full width: resumed step {at}")
    same = _restored_equals_checkpoint(tr, root / "full", at)
    _same_on_all(same, "full-width restored state equal to the checkpoint")
    resumed = [float(tr.train_step(tr.local_batch(data.batch(s)), s)["loss"])
               for s in range(at, at + MESH_FULL_NEXT)]
    # the control: the same steps on (4, 1) from fresh weights, as a
    # restore that loaded nothing would take them
    tr.init_state()
    control = [float(tr.train_step(tr.local_batch(data.batch(s)), s)["loss"])
               for s in range(at, at + MESH_FULL_NEXT)]
    del tr
    gap, gap_ctl = _rel_dist(resumed, straight), _rel_dist(control, straight)
    say(f"[mesh] saved at step {step + 1} on (2, 2), resumed on (4, 1): "
        f"this rank's restored state equal to the checkpoint bit for bit: "
        f"{same}; losses {[f'{x:.5f}' for x in resumed]} against "
        f"{[f'{x:.5f}' for x in straight]} straight on (2, 2): {gap:.2e} "
        f"relative (bf16; tol {MESH_BF16_TOL}); the control from fresh "
        f"weights {[f'{x:.5f}' for x in control]}: {gap_ctl:.2e}  [{card}]")
    require(same, "mesh full width: restored state != checkpoint")
    require(len(resumed) == MESH_FULL_NEXT and np.isfinite(resumed).all(),
            f"mesh full width resume: {resumed}")
    require(gap <= MESH_BF16_TOL and 10 * gap <= gap_ctl,
            f"mesh full width resume: {gap:.2e} (control {gap_ctl:.2e})")
    _free()
    return dict(ms=med, timed=timed_ms, per_rank=per_rank, split=split,
                losses=losses, straight=straight, resumed=resumed, gap=gap,
                control=control, gap_control=gap_ctl, full_p=full_p,
                full_o=full_o)


def _restored_equals_checkpoint(tr, directory, step) -> bool:
    """Whether a trainer's state just restored from ``directory`` equals
    the checkpoint of ``step`` bit for bit: its full parameters, and its
    own slice of each optimizer slot (the archive's keys: ``[0]/<leaf
    path>``, ``[1]/<slot path>``)."""
    with np.load(Path(directory) / f"step_{step}" / "arrays.npz") as z:
        for k, p in zip(tr.keys, tr.params):
            if to_numpy(p).tobytes() != z[f"[0]/{k}"].tobytes():
                return False
        for path, t in tr.opt_leaves().items():
            full = z[f"[1]/{path}"]
            idx = SH.shard_index(tr.ospecs[path], full.shape, tr.view,
                                 tr.coord)
            if to_numpy(t).tobytes() != np.ascontiguousarray(
                    full[idx]).tobytes():
                return False
    return True


def mesh_rank(rank, world, root, backend, settings):
    """One rank of phase 25 (spawned): joins the group, runs (a)-(c),
    and writes its results to ``root/rank<r>.pkl``; a failed check
    raises, which fails the phase."""
    globals().update(settings)
    torch.set_num_threads(1 if DEVICE == "cpu" else 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(root)
    dev = init_ranks(backend, device=DEVICE, init_method=f"file://{root}/store",
                     rank=rank, world_size=world, timeout_s=900)

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0] \
        if DEVICE == "cuda" else "cpu rehearsal"
    devices = _all(str(dev))
    say(f"[mesh] {world} ranks, backend {backend}, "
        f"torch.cuda.device_count() {torch.cuda.device_count()}, devices "
        f"{devices}  [{card}]")
    require(all(d.startswith(DEVICE) for d in devices),
            f"mesh: a rank is not on {DEVICE}: {devices}")
    out = dict(devices=devices)
    out["psum"] = _mesh_psum(rank, dev, say, card)
    out["smoke"] = _mesh_smoke(rank, dev, say, root / "smoke", card)
    out["full"] = _mesh_full(rank, dev, say, root, card)
    dist.barrier()
    dist.destroy_process_group()
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def phase_mesh(card):
    """Slice 13's main path: training on a (data, model) mesh of
    MESH_WORLD ranks, each a process (see MESH_WORLD).  Every rank runs
    every check; a failure in any rank fails the phase."""
    _free()
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if cards >= MESH_WORLD:
        backend, why = "nccl", f"{cards} cards: one a rank"
    else:
        backend = "gloo"
        why = (f"{MESH_WORLD} ranks share {cards} card(s), and NCCL takes "
               f"one card a rank" if DEVICE == "cuda" else "CPU rehearsal")
    print(f"[mesh] spawning {MESH_WORLD} ranks: backend {backend} ({why})")
    root = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    settings = {k: globals()[k] for k in MESH_SETTINGS}
    torch.multiprocessing.start_processes(
        mesh_rank, args=(MESH_WORLD, str(root), backend, settings),
        nprocs=MESH_WORLD, start_method="spawn")
    out = []
    for r in range(MESH_WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(root)
    return dict(backend=backend, ranks=out)


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def _kernel_entry(name, launches, row):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "bytes"),
            "library_ms": row["library_ms"]}


def main() -> int:
    # a float32 product on the card runs in full float32 (the references
    # here are float32 and float64); stated, not left to the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = timed("environment", phase_environment)
    timed("build", phase_build)
    timed("spmv grid", phase_grid)
    timed("tsm grid", phase_tsm_grid)
    timed("case study", phase_case_study)
    fw = timed("full width column CG", phase_full_width, card)
    timed("quickstart", phase_quickstart, fw["A64"])
    bcg = timed("block CG", phase_block_cg, fw, card)
    bminres = timed("block MINRES", phase_block_minres, fw, card)
    timed("eigensolvers", phase_eigen, fw, card)
    rows = timed("spmv timing", phase_timing, fw, card)
    tsm = timed("tsm timing", phase_tsm_timing, fw, card)
    eig = timed("block CG split", phase_block_split, fw, bcg, tsm, card)
    bcg128 = timed(f"block CG at width {WIDE_WIDTH}", phase_block_cg_wide,
                   fw, card)
    wide, wide_launches = timed("wide timing", phase_wide_timing, fw, bcg128,
                                card)
    # the paths below need the card's memory: keep only the counts
    bcg128 = {"launches": bcg128["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    timed("b4 grid", phase_b4_grid)
    timed("b5 grid", phase_b5_grid)
    timed("eigensolver grid", phase_eig_grid)
    timed("wide grid", phase_wide_grid)
    pcg = timed("preconditioned CG", phase_precond_cg, card)
    timed("complex grid", phase_complex_grid)
    cx = timed("complex solves", phase_complex_solves, fw, bcg, bminres, card)
    cxt = timed("complex timing", phase_complex_timing, cx, card)
    timed("mixed dtypes", phase_mixed_dtypes, fw, card)
    b5_cx_launches = cx["b5 launches"]
    cx_launches = cx["launches"]
    del cx
    gc.collect()
    torch.cuda.empty_cache()
    b5_launches = timed("b5 path", phase_b5_residual, pcg, card)
    timed("preconditioned MINRES", phase_precond_minres, pcg, card)
    timed("chebyshev PCG", phase_chebyshev_pcg, card)
    pre = timed("precond timing", phase_precond_timing, pcg, card)
    timed("pcg split", phase_pcg_split, pcg, card)
    timed("stepper", phase_stepper, fw, bcg, pcg, card)
    timed("coefficient syncs", phase_coef_syncs, fw, card)
    timed("serving", phase_serving, fw, pcg, card)
    timed("pool bandwidths", phase_bandwidths, card)
    mlg = timed("mlgeer distributed spmv", phase_mlgeer, card)
    gc.collect()
    torch.cuda.empty_cache()
    ecg = timed("engine CG", phase_engine_cg, fw, card)
    timed("rebalance loop", phase_rebalance, ecg["cpu + card"]["eng"], fw,
          card)
    served = timed("engine serving", phase_engine_serving,
                   ecg[f"{ENGINE_SHARDS} card shards"]["eng"], fw, card)
    cross = timed("engine across cards", phase_cross_cards, mlg, ecg, fw,
                  card)
    # B1's main paths: column CG, the paper's workload, engine CG,
    # serving, the engine across cards
    b1_launches = (fw["launches"] + mlg["launches"] + ecg["launches"]
                   + served + cross["launches"])
    del ecg, mlg, cross
    gc.collect()
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            torch.cuda.empty_cache()
    for r in rows:
        if r["b"] == 4:
            n = fw["launches"] if r["label"] == "f64" else fw["launches16"]
            kern_s = n * r["ms"] * 1e-3
            solve_s = fw["solve_s"][r["label"]]
            print(f"[time split] {r['label']} column CG b=4: {n} launches x "
                  f"{r['ms']:.4f} ms = {kern_s:.3f} s of the {solve_s:.3f} s "
                  f"solve ({100 * kern_s / solve_s:.1f}% in the SpMV kernel)")
    main_row = next(r for r in rows if r["label"] == "f64" and r["b"] == 4)
    f64 = torch.float64
    entries = [
        _kernel_entry(KERNEL, b1_launches, main_row),
        _kernel_entry("tsmttsm", bcg["launches"]["tsmttsm"],
                      tsm[("tsmttsm", "kahan", f64)]),
        _kernel_entry("tsmm", bcg["launches"]["tsmm"],
                      tsm[("tsmm", "with W", f64)]),
        _kernel_entry("block_diag_matmul",
                      pcg["launches"]["block_diag_matmul"],
                      pre[("block_diag_matmul", "f64")]),
        # B5 has no solver path: its launches are the PCG residual check's
        _kernel_entry("fused_axpby_dots", b5_launches,
                      pre[("fused_axpby_dots", "f64")]),
        # ... and, complex128, the complex CG residual check's
        dict(_kernel_entry("fused_axpby_dots", b5_cx_launches,
                           cxt[("fused_axpby_dots", torch.complex128)]),
             variant="complex128"),
        # B1 and B2 on complex128 values: the launches of phase 13c's
        # complex128 solves (column CG, block CG, block MINRES, pipelined
        # CG, PCG, PMINRES), the times at column CG's and block CG's widths
        dict(_kernel_entry(KERNEL, cx_launches.get(KERNEL, 0),
                           cxt[(KERNEL, torch.complex128, 4)]),
             variant="complex128"),
        dict(_kernel_entry("tsmttsm", cx_launches.get("tsmttsm", 0),
                           cxt[("tsmttsm", torch.complex128, True)]),
             variant="complex128"),
        # the port's own kernel, on block CG's path (two calls an iteration)
        _kernel_entry("herm_eig", bcg["launches"]["herm_eig"], eig),
        # the instances past the narrow designs (slice 19): B2, B3 and the
        # eigensolver on block CG at width 128 (their launches there, their
        # times at 4,096,000 x 128 and m = 128); B1's tall chunks on column
        # CG at C = 1024, B4 at bs = 128 on block-Jacobi PCG, B6 at N = 128
        # in a Mamba mixer (the launches of those paths)
        dict(_kernel_entry(KERNEL, wide_launches["sellcs_spmv"],
                           wide["sellcs_spmv"]), variant="wide"),
        dict(_kernel_entry("tsmttsm", bcg128["launches"]["tsmttsm"],
                           wide[("tsmttsm", "kahan")]), variant="wide"),
        dict(_kernel_entry("tsmm", bcg128["launches"]["tsmm"],
                           wide[("tsmm", "with W")]), variant="wide"),
        dict(_kernel_entry("herm_eig", bcg128["launches"]["herm_eig"],
                           wide["herm_eig"]), variant="wide"),
        dict(_kernel_entry("block_diag_matmul",
                           wide_launches["block_diag_matmul"],
                           wide["block_diag_matmul"]), variant="wide"),
        dict(_kernel_entry("mamba_scan", wide_launches["mamba_scan"],
                           wide["mamba_scan"]), variant="wide"),
    ]
    # the LM phases need the card's memory: keep only the numbers above
    del fw, bcg, pcg, rows, tsm, pre, cxt
    gc.collect()
    torch.cuda.empty_cache()

    timed("b6 grid", phase_b6_grid)
    timed("b6 exponential", phase_b6_exp2)
    gc.collect()
    torch.cuda.empty_cache()
    lm = timed("prefill at full width", phase_prefill, card)
    with ClockSampler() as sampler:
        scan_args = timed("prefill split", phase_prefill_split, lm, card,
                          sampler)
    timed("serve at full width", phase_serve, lm, card)
    launches = lm["launches"]
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    timed("decode vs forward, f32, full width", phase_decode_vs_forward, card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("moe card vs cpu", phase_moe, card)
    b6 = timed("b6 timing", phase_b6_timing, card, scan_args)
    entries.append(_kernel_entry("mamba_scan", launches, b6))
    del scan_args
    rows = [timed(f"{arch} at full width", phase_arch, arch, card)
            for arch in ARCHS_8B]
    print_arch_table(rows, card)
    timed("train", phase_train, card)
    timed("dry run", phase_dryrun, card)
    timed("mesh training", phase_mesh, card)
    print(f"[phase] all phases: {time.perf_counter() - t_start:.1f} s")
    for e in entries:
        require(e["launches"] > 0, f"{e['name']} {e.get('variant', '')}: no "
                f"launch on its main path")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
