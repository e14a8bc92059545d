"""The port's cyclic-reduction preconditioner against the JAX package's,
float64 on the CPU, for block counts that are and are not powers of two:
the factor levels, single and multi right-hand-side solves (1e-12
relative, and against a dense solve), and the tridiagonal blocks taken
from a linearised graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.solver import linear as jlin
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import problem as jp
from slam_tpu.solver import tridiag as jtd
from slam_tpu.solver.models import SE2Model as JaxSE2
from slam_tpu_torch import convert
from slam_tpu_torch.solver import linear as tlin
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver import tridiag as ttd
from slam_tpu_torch.solver.models import SE2Model as TorchSE2

SHAPES = [(1, 3), (2, 3), (7, 3), (64, 3), (97, 3), (40, 6)]


def _close(t, j, rtol=1e-12, err_msg=""):
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(np.asarray(t), j, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _system(n, B):
    rng = np.random.default_rng(n * 10 + B)
    U = rng.normal(size=(n - 1, B, B)) * 0.3
    D = np.einsum("nij,nkj->nik", rng.normal(size=(n, B, 2 * B)),
                  rng.normal(size=(n, B, 2 * B)))
    D = 0.5 * (D + np.swapaxes(D, -1, -2)) + np.eye(B)[None] * (5 + 0.6 * B)
    T = np.zeros((n * B, n * B))
    for i in range(n):
        T[i * B:(i + 1) * B, i * B:(i + 1) * B] = D[i]
    for i in range(n - 1):
        T[i * B:(i + 1) * B, (i + 1) * B:(i + 2) * B] = U[i]
        T[(i + 1) * B:(i + 2) * B, i * B:(i + 1) * B] = U[i].T
    return D, U, T, rng


@pytest.mark.parametrize("n,B", SHAPES)
def test_build_cr_factors_matches(n, B):
    D, U, _, _ = _system(n, B)
    jlev, jroot, jm, jn = jtd.build_cr_factors(jnp.asarray(D), jnp.asarray(U))
    tlev, troot, tm, tn = ttd.build_cr_factors(torch.as_tensor(D),
                                               torch.as_tensor(U))
    assert (tm, tn) == (jm, jn)
    assert tm & (tm - 1) == 0 and tm >= n
    assert len(tlev) == len(jlev)
    for k, (tl_, jl_) in enumerate(zip(tlev, jlev)):
        for name, t, j in zip(("Dinv_odd", "U_left", "U_right"), tl_, jl_):
            _close(t, j, err_msg=f"level {k} {name}")
    _close(troot, jroot, err_msg="root_inv")


@pytest.mark.parametrize("n,B", SHAPES)
def test_cr_solve_matches(n, B):
    D, U, T, rng = _system(n, B)
    r = rng.normal(size=(n, B))
    j = jtd.cr_solve(jtd.build_cr_factors(jnp.asarray(D), jnp.asarray(U)),
                     jnp.asarray(r))
    t = ttd.cr_solve(ttd.build_cr_factors(torch.as_tensor(D),
                                          torch.as_tensor(U)),
                     torch.as_tensor(r))
    _close(t, j)
    np.testing.assert_allclose(
        t.numpy(), np.linalg.solve(T, r.reshape(-1)).reshape(n, B),
        rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n,B", SHAPES)
def test_cr_solve_mrhs_matches(n, B):
    D, U, T, rng = _system(n, B)
    K = 5
    r = rng.normal(size=(n, B, K))
    j = jtd.cr_solve_mrhs(
        jtd.build_cr_factors(jnp.asarray(D), jnp.asarray(U)), jnp.asarray(r))
    factors = ttd.build_cr_factors(torch.as_tensor(D), torch.as_tensor(U))
    t = ttd.cr_solve_mrhs(factors, torch.as_tensor(r))
    _close(t, j)
    for k in range(K):  # column k is the single-rhs solve of column k
        _close(t[:, :, k], ttd.cr_solve(factors,
                                        torch.as_tensor(r[:, :, k])))
    np.testing.assert_allclose(
        t.numpy().reshape(n * B, K), np.linalg.solve(T, r.reshape(n * B, K)),
        rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("robust", ["dcs", "sc"])
@pytest.mark.parametrize("pad_to", [256, None])
def test_extract_tridiag_matches(circle_outliers, robust, pad_to):
    g = circle_outliers[0].canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float64, pad_to=pad_to)
    rng = np.random.default_rng(4)
    poses = g.poses + rng.normal(scale=0.05, size=g.poses.shape)
    sw = rng.uniform(0.2, 1.0, size=je.num_edges)
    kw = dict(robust=robust, dcs_phi=0.5, huber_delta=0.01,
              sc_prior_lambda=1.0)
    js = jl.linearize(jnp.asarray(poses), jnp.asarray(sw), je,
                      jp.anchor_first_node(g.num_nodes, dtype=jnp.float64),
                      model=JaxSE2, **kw)
    ts = tl.linearize(torch.as_tensor(poses), torch.as_tensor(sw), te,
                      tp.anchor_first_node(g.num_nodes), model=TorchSE2,
                      **kw)
    jHd, _ = jlin._damped_diag(js, jnp.asarray(1e-3))
    tHd, _ = tlin.damped_diag(ts, torch.tensor(1e-3, dtype=torch.float64))
    jD, jU = jtd.extract_tridiag(js, je, jHd)
    tD, tU = ttd.extract_tridiag(ts, te, tHd)
    assert tU.shape == (g.num_nodes - 1, 3, 3)
    _close(tD, jD, err_msg="D")
    _close(tU, jU, err_msg="U")
