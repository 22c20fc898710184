"""The port's small Hermitian eigensolver (``kernels/csrc/herm_eig.cu``
behind ``kernels.ops.herm_eig``), which the block-Krylov solvers' (b, b)
eigendecompositions go through.

On the CPU ``ops.herm_eig`` is ``torch.linalg.eigh`` itself, so the block
solvers' CPU parity counts do not move.  The ``gpu``-marked tests hold
the Jacobi kernel against ``torch.linalg.eigh`` in float64 (complex128)
on the same inputs.  Eigenvectors are fixed only up to a phase and
within a repeated eigenvalue's space, so U is not compared entry by
entry; with eps the machine epsilon of the dtype's real type and
||A|| = ||A||_F:

* the eigenvalues within 4 m eps ||A|| of the reference's;
* ||A U - U diag(w)||_F within 16 m eps ||A||;
* ||U^H U - I||_F within 16 m eps (a float32 emulation of the kernel's
  rotations at m = 64 gives about 10 m eps);
* the converged flag set, and no host synchronisation in the call.
"""
import pytest
import torch

from repro_torch.core import execution
from repro_torch.kernels import ops
from repro_torch.kernels import herm_eig as he
from repro_torch.kernels.herm_eig import herm_eig_cuda

DTYPES = [torch.float64, torch.float32, torch.complex128, torch.complex64]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _matrix(kind, m, dtype, device, seed=0):
    """A Hermitian (m, m) matrix: a random Gram matrix, a rank-deficient
    Gram of rank m // 2, or one with two eigenvalues of multiplicity
    about m / 2 each."""
    g = torch.Generator(device=device).manual_seed(seed + m)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    X = torch.randn(m, m, generator=g, dtype=wide, device=device)
    if kind == "gram":
        A = X @ X.mH
    elif kind == "rank_deficient":
        Y = X[:, :m // 2]
        A = Y @ Y.mH
    else:
        Q, _ = torch.linalg.qr(X)
        d = torch.where(torch.arange(m, device=device) < m // 2, 1.0, 2.0)
        A = (Q * d.to(wide)) @ Q.mH
    return (0.5 * (A + A.mH)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_cpu_takes_torch_eigh(dtype):
    A = _matrix("gram", 7, dtype, "cpu")
    execution.reset_launch_counts()
    w, U, conv = ops.herm_eig(A)
    want_w, want_U = torch.linalg.eigh(A)
    assert torch.equal(w, want_w) and torch.equal(U, want_U)
    assert conv.dtype == torch.bool and conv.shape == () and bool(conv)
    assert execution.launch_counts().get("herm_eig", 0) == 0
    w3, _, conv3 = ops.herm_eig(torch.stack([A, 2 * A]))
    assert w3.shape == (2, 7) and conv3.shape == (2,)


@pytest.mark.parametrize("m,order,values", [
    (1, 16, 0), (64, 64, 0), (65, 80, 65 * 80 + 80 * 84 + 5 * 848),
    (96, 96, 96 * 96 + 96 * 100 + 6 * 848),
    (128, 128, 128 * 128 + 128 * 132 + 8 * 848),
    (200, 208, 200 * 208 + 208 * 212 + 13 * 848)])
def test_wide_order_and_workspace(m, order, values):
    """The block-Jacobi instance solves at m rounded up to whole pairs of
    8-index blocks, and its workspace holds U, A and the pairs'
    subproblems and factors (none up to the narrow design's 64)."""
    assert he.wide_order(m) == order
    assert he.work_values(m) == values
    assert order % (2 * he.BLOCK) == 0 and order - m < 2 * he.BLOCK


def test_wrapper_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors"):
        herm_eig_cuda(torch.eye(3))


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gram", "rank_deficient", "repeated"])
@pytest.mark.parametrize("m", [1, 2, 3, 16, 17, 64, 65, 96, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_kernel_matches_eigh_on_card(dtype, m, kind):
    need_card()
    A = _matrix(kind, m, dtype, "cuda")
    wide = torch.complex128 if dtype.is_complex else torch.float64
    execution.reset_launch_counts()
    with torch.cuda.device(A.device):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            w, U, conv = ops.herm_eig(A)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert execution.launch_counts()["herm_eig"] == 1
    assert conv.device.type == "cuda" and bool(conv)
    real = A.real.dtype if dtype.is_complex else dtype
    assert w.dtype == real and U.dtype == dtype
    assert w.shape == (m,) and U.shape == (m, m)
    eps = torch.finfo(real).eps
    Ad = A.to(wide)
    norm = float(torch.linalg.norm(Ad))
    want = torch.linalg.eigvalsh(Ad)
    assert bool(torch.all(w[1:] >= w[:-1]))
    assert float((w.double() - want).abs().max()) <= 4 * m * eps * norm
    Ud, wd = U.to(wide), w.to(wide)
    assert (float(torch.linalg.norm(Ad @ Ud - Ud * wd[None, :]))
            <= 16 * m * eps * norm + 1e-300)
    eye = torch.eye(m, dtype=wide, device="cuda")
    assert float(torch.linalg.norm(Ud.mH @ Ud - eye)) <= 16 * m * eps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_batched_kernel_on_card(dtype):
    """A batch of matrices, one block each, equals the matrices one at a
    time to the bit; the lower triangle alone is read."""
    need_card()
    A = torch.stack([_matrix("gram", 16, dtype, "cuda", seed=s)
                     for s in range(5)])
    w, U, conv = ops.herm_eig(A)
    assert w.shape == (5, 16) and U.shape == (5, 16, 16)
    assert bool(conv.all()) and conv.shape == (5,)
    for i in range(5):
        wi, Ui, _ = ops.herm_eig(A[i])
        assert torch.equal(wi, w[i]) and torch.equal(Ui, U[i])
    upper = torch.triu(torch.ones(16, 16, device="cuda"), 1).bool()
    junk = A[0].masked_fill(upper, 7.0)
    w0, U0, _ = ops.herm_eig(junk)
    assert torch.equal(w0, w[0]) and torch.equal(U0, U[0])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gram", "rank_deficient", "repeated"])
@pytest.mark.parametrize("m", [65, 96, 128, 200])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_block_jacobi_batch_equals_one_at_a_time(dtype, m, kind):
    """The block-Jacobi instance: a batch of three matrices (a block and a
    workspace slice each) equals the matrices one at a time to the bit,
    every flag is set, and each is within the bounds above."""
    need_card()
    A = torch.stack([_matrix(kind, m, dtype, "cuda", seed=s)
                     for s in range(3)])
    w, U, conv = herm_eig_cuda(A)
    assert bool((conv > 0).all())
    real = A.real.dtype if dtype.is_complex else dtype
    eps = torch.finfo(real).eps
    wide = torch.complex128 if dtype.is_complex else torch.float64
    eye = torch.eye(m, dtype=wide, device="cuda")
    for i in range(3):
        wi, Ui, ci = herm_eig_cuda(A[i])
        assert torch.equal(wi, w[i]) and torch.equal(Ui, U[i])
        assert int(ci) == int(conv[i])
        Ad = A[i].to(wide)
        norm = float(torch.linalg.norm(Ad))
        want = torch.linalg.eigvalsh(Ad)
        assert float((wi.double() - want).abs().max()) <= 4 * m * eps * norm
        Ud = Ui.to(wide)
        assert float(torch.linalg.norm(Ud.mH @ Ud - eye)) <= 16 * m * eps


@pytest.mark.gpu
def test_block_jacobi_workspace_matches_the_kernel():
    """The wrapper's workspace size is the one the CUDA source counts."""
    need_card()
    import ctypes
    from repro_torch.kernels import _build
    fn = _build.load("herm_eig").herm_eig_work_values
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    for m in (1, 64, 65, 96, 128, 200, 1000):
        assert fn(m) == he.work_values(m)
