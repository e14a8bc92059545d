"""The stack factor ``ops.stack_chol.stack_cholesky`` and its caller
``linear._finish_dense``.

On the CPU the wrapper takes the plain version (``cholesky_ex`` a lane):
its layout, its infos, a failed lane's NaN, one system as a stack of one,
and what the wrapper refuses.  Tests marked ``cuda`` hold the kernel
(``csrc/stack_chol.cu``) to a float64 factor, a lane to its matrix alone
and a failed lane to LAPACK's info; they skip without a card, and on one
run with ``python -m pytest --noconftest -m cuda
tests/test_torch_stack_chol.py`` (this file imports no JAX).
"""

import numpy as np
import pytest
import torch

from slam_tpu_torch import ops
from slam_tpu_torch.ops.stack_chol import Schedule, schedule, \
    stack_cholesky, stack_cholesky_plain
from slam_tpu_torch.solver import linear
from slam_tpu_torch.tools.stack_factor import jacobi, spd_stack


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs on the card only")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CPU: the plain route and the wrapper's checks
# ---------------------------------------------------------------------------

def test_plain_route_layout_info_and_failed_lane_nan():
    """Column-major factors (as ``cholesky_ex`` gives them), LAPACK's
    1-based info for the lane that is not SPD and 0 elsewhere, each good
    lane its matrix's factor alone, and ``_finish_dense`` gives NaN in the
    failed lane only."""
    A = spd_stack(3, 12)
    A[1, 4, 4] = -1.0
    ops.reset_launches()
    L, info = stack_cholesky(A)
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain version
    assert L.shape == A.shape and L.mT.is_contiguous()
    assert info.dtype == torch.int32 and info.tolist() == [0, 5, 0]
    for k in (0, 2):
        assert torch.equal(L[k], torch.linalg.cholesky_ex(A[k])[0])
    rhs = torch.ones((3, 12), dtype=torch.float64)
    upd = linear._finish_dense(A, rhs, 4, 3, 0, False)
    x = upd.poses.reshape(3, 12)
    assert torch.isnan(x[1]).all()
    assert torch.isfinite(x[[0, 2]]).all()
    np.testing.assert_allclose(
        (A[[0, 2]] @ x[[0, 2], :, None])[..., 0].numpy(),
        rhs[[0, 2]].numpy(), rtol=0, atol=1e-12)


def test_scale_is_the_plain_products():
    """With ``dscale`` the factor is that of ``(A_ij d_i) d_j``, the two
    products rounded in that order, to the bit; a strided stack (a
    corner of a larger one) factors as its contiguous copy."""
    big = spd_stack(2, 20, torch.float32, seed=1)
    A = big[:, :17, :17]
    d = jacobi(A)
    L, info = stack_cholesky(A, d)
    Ls, _ = stack_cholesky_plain(A.contiguous() * d[:, :, None]
                                 * d[:, None, :])
    assert info.tolist() == [0, 0]
    assert torch.equal(L, Ls)


def test_one_system_is_lane_zero_of_a_stack_of_one():
    """The 2-D ``_finish_dense`` is the stack of one: the same update to
    the bit, with and without switch unknowns."""
    A = spd_stack(1, 15, seed=2)
    rhs = torch.linspace(-1, 1, 15, dtype=torch.float64)
    for switches, E in ((False, 0), (True, 6)):
        one = linear._finish_dense(A[0], rhs, 3, 3, E, switches)
        stack = linear._finish_dense(A, rhs[None], 3, 3, E, switches)
        assert torch.equal(one.poses, stack.poses)
        assert torch.equal(one.switches, stack.switches)


@pytest.mark.parametrize("shape, dtype", [
    ((5, 5), torch.float64),
    ((2, 5, 4), torch.float64),
    ((2, 2, 5, 5), torch.float64),
    ((2, 5, 5), torch.float16),
    ((2, 5, 5), torch.int32),
])
def test_refuses_before_either_route(shape, dtype):
    """Not a ``(B, n, n)`` stack of float32 or float64: raised before the
    plain version (CPU) or the kernel (meta tensors stand for a card)."""
    for device in ("cpu", "meta"):
        A = torch.zeros(shape, dtype=dtype, device=device)
        with pytest.raises((ValueError, TypeError)):
            stack_cholesky(A)


def test_refuses_a_scale_of_another_shape():
    A = spd_stack(2, 6)
    with pytest.raises(ValueError):
        stack_cholesky(A, torch.ones(2, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        stack_cholesky(A, torch.ones(2, 6, dtype=torch.float32))


@pytest.mark.parametrize("n, dtype, nb, group, kernels", [
    (5217, torch.float32, 128, 3, 94),
    (3950, torch.float32, 128, 3, 71),
    (1662, torch.float32, 64, 2, 63),
    (3684, torch.float64, 64, 6, 124),
    (1662, torch.float64, 64, 2, 63),
    (97, torch.float32, 64, 2, 4),
    (64, torch.float64, 64, 2, 2),
    (1, torch.float32, 64, 2, 2),
])
def test_schedule_and_launches(n, dtype, nb, group, kernels):
    """The block width and group by order and dtype, and the device
    kernels a call launches: the staging pass, the first diagonal block,
    a panel a block but the last, an update a further block column, and
    a far update a group but the last two."""
    s = schedule(n, dtype)
    assert s == Schedule(nb, group)
    assert s.launches(n) == kernels
    assert s.launches(0) == 0


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _kernel_error(A, dtype):
    """Max |L - L64| of the kernel and of the cuSOLVER loop, both in
    ``dtype``, against the float64 factor of the same rounded matrix."""
    Ad = A.to(dtype)
    ref = torch.linalg.cholesky(Ad.double())
    L, info = stack_cholesky(Ad)
    Lc, _ = stack_cholesky_plain(Ad)
    torch.cuda.synchronize()
    assert info.tolist() == [0] * A.shape[0]
    assert L.mT.is_contiguous()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    return ((L.double() - ref).abs().max().item(),
            (Lc.double() - ref).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 97, 128, 129, 750, 5217])
def test_kernel_against_float64(cuda_device, n, dtype):
    lanes = 1 if n == 5217 else 3
    A = spd_stack(lanes, n, seed=n, device=cuda_device)
    ops.reset_launches()
    err, lib = _kernel_error(A, dtype)
    assert ops.launch_counts()["stack_cholesky"] == schedule(
        n, dtype).launches(n)
    eps = torch.finfo(dtype).eps
    assert err <= max(4 * lib, 64 * eps), (err, lib)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [129, 1000, 2500])
def test_lane_of_eight_is_its_matrix_alone(cuda_device, n, dtype):
    """Lane k of a stack of 8 equals the same matrix as a stack of 1, to
    the bit, scaled or not."""
    A = spd_stack(8, n, dtype, seed=n, device=cuda_device)
    d = jacobi(A)
    for scale in (None, d):
        L, info = stack_cholesky(A, scale)
        for k in (0, 3, 7):
            Lk, ik = stack_cholesky(A[k:k + 1], None if scale is None
                                    else scale[k:k + 1])
            assert torch.equal(L[k], Lk[0]) and info[k] == ik[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, bad", [(300, 200), (300, 5), (1200, 1100)])
def test_failed_lane_reports_lapack_info(cuda_device, n, bad, dtype):
    """A lane whose leading minor of order ``bad + 1`` is not positive
    reports ``bad + 1``, the others 0 with finite factors equal to their
    matrices' alone."""
    A = spd_stack(4, n, dtype, seed=bad, device=cuda_device)
    A[2, bad, bad] = -1.0
    L, info = stack_cholesky(A)
    assert info.tolist() == [0, 0, bad + 1, 0]
    for k in (0, 1, 3):
        assert torch.isfinite(L[k]).all()
        assert torch.equal(L[k], stack_cholesky(A[k:k + 1])[0][0])
    rhs = torch.ones((4, n), dtype=dtype, device=cuda_device)
    x = linear._finish_dense(A, rhs, n // 3, 3, 0, False).poses.reshape(4, n)
    assert torch.isnan(x[2]).all() and torch.isfinite(x[[0, 1, 3]]).all()
