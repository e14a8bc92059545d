"""The blocked-Cholesky slice of the port on the CPU: ``micro_chol_inv``'s
plain version against the JAX Pallas kernel (interpret mode) and NumPy,
``blocked_chol`` against the JAX package's, ``schur_solve(blocked=True)``
against the JAX ``schur_solve`` with the same flags and the dense solve,
and a few LM iterations of the blocked+micro configuration in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import SolverConfig
from slam_tpu.io import synthetic
from slam_tpu.ops import pallas_chol as jchol
from slam_tpu.solver import blocked_chol as jbc
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu.solver.models import SE2Model as JaxSE2
from slam_tpu.solver.partition import graph_partition
from slam_tpu_torch import convert, ops
from slam_tpu_torch.ops import chol as tchol
from slam_tpu_torch.solver import blocked_chol as tbc
from slam_tpu_torch.solver import linear as tlinear
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import lm as tlm
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver import schur as ts
from slam_tpu_torch.solver.models import SE2Model as TorchSE2

# float32 as in tests/test_pallas_chol.py; float64 agrees to rounding.
ATOL = {np.float32: 2e-4, np.float64: 1e-10}
KW = dict(robust="dcs", dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)
LAM = 1e-3
_STATIC = ("blocked", "panel", "panel_inner", "pallas_micro")


def _spd_batch(m, p, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, p, p))
    return (A @ np.swapaxes(A, -1, -2) + p * np.eye(p)).astype(dtype)


def _strict_upper(x, p):
    iu = np.triu_indices(p, 1)
    return np.asarray(x)[:, iu[0], iu[1]]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [8, 32])
def test_micro_chol_inv_plain_matches_pallas_and_numpy(p, dtype):
    A = _spd_batch(12, p, seed=p, dtype=dtype)
    jL, jinv = jchol.micro_chol_inv(jnp.asarray(A), interpret=True)
    tL, tinv = tchol.micro_chol_inv(torch.as_tensor(A))
    assert tL.dtype == tinv.dtype == torch.from_numpy(A).dtype
    L_ref = np.linalg.cholesky(A.astype(np.float64))
    inv_ref = np.linalg.inv(L_ref)
    for t, j, ref in ((tL, jL, L_ref), (tinv, jinv, inv_ref)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL[dtype])
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=ATOL[dtype])
        assert np.all(_strict_upper(t.numpy(), p) == 0.0)
        assert np.all(_strict_upper(j, p) == 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_non_spd_panel_gives_nan_in_both(dtype):
    A = _spd_batch(4, 8, seed=1, dtype=dtype)
    A[2, 5, 5] = -A[2, 5, 5]  # pivot 5 of matrix 2 turns negative
    jL, jinv = jchol.micro_chol_inv(jnp.asarray(A), interpret=True)
    tL, tinv = tchol.micro_chol_inv(torch.as_tensor(A))
    for x in (np.asarray(jL), np.asarray(jinv), tL.numpy(), tinv.numpy()):
        assert np.isnan(x[2]).any()
        assert np.isfinite(np.delete(x, 2, axis=0)).all()
    np.testing.assert_array_equal(np.isnan(tL.numpy()), np.isnan(np.asarray(jL)))


def test_wrapper_checks_before_any_launch():
    """A non-CPU tensor never takes the plain version: its shape, dtype and
    panel width are checked for the kernel (a meta tensor stops there)."""
    assert tchol.max_panel(torch.float32) == 240
    assert tchol.max_panel(torch.float64) == 169
    for shape, dtype, err in (((2, 241, 241), torch.float32, ValueError),
                              ((2, 170, 170), torch.float64, ValueError),
                              ((2, 8, 9), torch.float32, ValueError),
                              ((2, 8, 8), torch.float16, TypeError)):
        with pytest.raises(err):
            tchol.micro_chol_inv(torch.empty(shape, dtype=dtype,
                                             device="meta"))


def _jax_factor(A, inner, micro):
    return jbc.blocked_cholesky(jnp.asarray(A), panel=16, inner=inner,
                                pallas_micro=micro)


@pytest.mark.parametrize("inner,micro,dtype", [(0, False, np.float64),
                                               (8, False, np.float64),
                                               (0, True, np.float32)])
def test_blocked_chol_matches_jax(inner, micro, dtype):
    """n = 52 with panel 16 pads to 64; 8 matrices reach the micro gate."""
    A = _spd_batch(8, 52, seed=3, dtype=dtype)
    B = np.random.default_rng(4).normal(size=(8, 52, 5)).astype(dtype)
    jf = _jax_factor(A, inner, micro)
    ops.reset_launches()
    tf = tbc.blocked_cholesky(torch.as_tensor(A), panel=16, inner=inner,
                              pallas_micro=micro)
    tol = dict(rtol=0, atol=ATOL[dtype])
    np.testing.assert_allclose(tf.L.numpy(), np.asarray(jf.L), **tol)
    assert len(tf.inv_diag) == len(jf.inv_diag) == 4
    for t, j in zip(tf.inv_diag, jf.inv_diag):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
    Bp = np.concatenate([B, np.zeros((8, 12, 5), dtype)], axis=1)
    Y = tbc.solve_lower(tf, torch.as_tensor(Bp))
    np.testing.assert_allclose(Y.numpy(),
                               np.asarray(jbc.solve_lower(jf, jnp.asarray(Bp))),
                               **tol)
    np.testing.assert_allclose(
        tbc.solve_lower_t(tf, Y).numpy(),
        np.asarray(jbc.solve_lower_t(jf, jnp.asarray(Y.numpy()))), **tol)
    x = tbc.cho_solve_blocked(tf, torch.as_tensor(B))
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jbc.cho_solve_blocked(jf, jnp.asarray(B))),
        **tol)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, B), **tol)
    xv = tbc.cho_solve_blocked(tf, torch.as_tensor(B[..., 0]))
    np.testing.assert_allclose(xv.numpy(), x[..., 0].numpy(), **tol)
    assert ops.launch_counts()["micro_chol_inv"] == 0  # CPU: plain version


def test_blocked_panel_failure_is_nan():
    A = _spd_batch(2, 40, seed=6)
    A[1, 20, 20] = -1.0
    fac = tbc.blocked_cholesky(torch.as_tensor(A), panel=16)
    x = tbc.cho_solve_blocked(fac, torch.ones(2, 40, dtype=torch.float64))
    assert np.isfinite(x[0].numpy()).all()
    assert np.isnan(x[1].numpy()).all()


@pytest.fixture(scope="module")
def problem():
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    g = graph.add_random_outliers(8, seed=2).canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=256,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float64, pad_to=256)
    jf = jp.anchor_first_node(g.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(g.num_nodes)
    poses = g.poses + np.random.default_rng(5).normal(scale=0.05,
                                                      size=g.poses.shape)
    jsys = jl.linearize(jnp.asarray(poses), jnp.ones(je.num_edges), je, jf,
                        model=JaxSE2, **KW)
    tsys = tl.linearize(torch.as_tensor(poses),
                        torch.ones(te.num_edges, dtype=torch.float64), te,
                        tf, model=TorchSE2, **KW)
    dense = tlinear.dense_solve(tsys, te, torch.tensor(LAM,
                                                       dtype=torch.float64),
                                tlinear.dense_plan(te)).poses.numpy()
    return g, je, te, jsys, tsys, dense


def _partitions(g, ij, kind, dtype):
    kw = {}
    if kind == "spectral":
        P = 4
        kw["node_block"] = graph_partition(ij, g.num_nodes, P)
    else:
        P = int(kind)
    jpart = js.build_partition(ij, g.num_nodes, P, dtype=dtype, **kw)
    tpart = ts.build_partition(ij, g.num_nodes, P,
                               dtype=torch.float32 if dtype == jnp.float32
                               else torch.float64, **kw)
    return jpart, tpart


def _jax_solve(sys_, edges, part, lam, **flags):
    solve = jax.jit(js.schur_solve.__wrapped__, static_argnames=_STATIC)
    return np.asarray(solve(sys_, edges, part, lam, **flags).poses)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("kind", ["4", "8", "spectral"])
def test_blocked_schur_matches_jax_and_dense(problem, monkeypatch, kind,
                                             inverse):
    g, je, te, jsys, tsys, dense = problem
    if not inverse:  # the cho_solve branch in both packages
        monkeypatch.setattr(js, "_INV_MAX_DIM", 0)
        monkeypatch.setattr(ts, "_INV_MAX_DIM", 0)
    flags = dict(blocked=True, panel=16)
    jpart, tpart = _partitions(g, np.asarray(je.ij), kind, jnp.float64)
    jx = _jax_solve(jsys, je, jpart, jnp.asarray(LAM), **flags)
    tx = ts.schur_solve(tsys, te, tpart, torch.tensor(LAM,
                                                      dtype=torch.float64),
                        **flags).poses.numpy()
    scale = np.abs(jx).max()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(tx, dense, rtol=0, atol=1e-9 * scale)


def _f32(sys_, lib):
    if lib == "jax":
        return type(sys_)(*(jnp.asarray(x, jnp.float32) for x in sys_))
    return type(sys_)(*(x.to(torch.float32) for x in sys_))


@pytest.mark.parametrize("inverse", [True, False])
def test_blocked_micro_schur_float32(problem, monkeypatch, inverse):
    """panel 16, P = 8 interiors: the micro gate is open in both packages
    (the JAX package's asks for float32 and a batch of at least 8).  1e-4 x max|x| against JAX (float32 rounding of
    two differently ordered factorisations) and 1e-3 against the float64
    dense solve (the float32 solve's own error)."""
    g, je, te, jsys, tsys, dense = problem
    if not inverse:
        monkeypatch.setattr(js, "_INV_MAX_DIM", 0)
        monkeypatch.setattr(ts, "_INV_MAX_DIM", 0)
    flags = dict(blocked=True, panel=16, pallas_micro=True)
    jpart, tpart = _partitions(g, np.asarray(je.ij), "8", jnp.float32)
    assert jpart.num_blocks == tpart.num_blocks == 8
    jx = _jax_solve(_f32(jsys, "jax"), je, jpart, jnp.float32(LAM), **flags)
    tx = ts.schur_solve(_f32(tsys, "torch"), te, tpart,
                        torch.tensor(LAM, dtype=torch.float32),
                        **flags).poses.numpy()
    assert tx.dtype == np.float32
    scale = np.abs(dense).max()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tx, dense, rtol=0, atol=1e-3 * scale)


def test_lm_fixed_iters_blocked_micro_float32():
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    g = graph.add_random_outliers(8, seed=2).canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float32, pad_to=256,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float32, pad_to=256)
    jpart, tpart = _partitions(g, np.asarray(je.ij), "8", jnp.float32)
    cfg = SolverConfig(robust="dcs", linear_solver="schur", dtype="float32",
                       schur_blocked=True, schur_panel=16,
                       schur_pallas_micro=True, use_pallas="off")
    E = je.num_edges
    j = jlm.lm_fixed_iters(jnp.asarray(g.poses, jnp.float32),
                           jnp.ones(E, jnp.float32), je,
                           jp.anchor_first_node(g.num_nodes,
                                                dtype=jnp.float32),
                           cfg, 5, partition=jpart)
    t = tlm.lm_fixed_iters(torch.as_tensor(g.poses),
                           torch.ones(E, dtype=torch.float32), te,
                           tp.anchor_first_node(g.num_nodes,
                                                dtype=torch.float32),
                           convert.config_from_jax(cfg), 5, partition=tpart)
    assert t.cost.dtype == torch.float32
    assert int(t.accepted) == int(j.accepted) > 0
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-4)
    assert float(t.cost) < 0.7 * float(t.initial_cost)


def test_max_panel_by_launch_shape():
    """``max_panel`` per dtype is the largest ``p`` whose tile and vector,
    ``p (p + 2)`` elements, fit the shared memory a block may opt into; the
    kernel picks its launch shape itself, and the wrapper raises beyond
    that ``p`` before any launch."""
    for dtype, want in ((torch.float32, 240), (torch.float64, 169)):
        p, size = tchol.max_panel(dtype), torch.finfo(dtype).bits // 8
        assert p == want
        assert p * (p + 2) * size <= tchol._SMEM_OPTIN \
            < (p + 1) * (p + 3) * size
    before = tchol.micro_chol_inv.launches
    for shape, dtype in (((2, 241, 241), torch.float32),
                         ((2, 170, 170), torch.float64),
                         ((1, 241, 241), torch.float32)):
        with pytest.raises(ValueError):
            tchol.micro_chol_inv(torch.empty(shape, dtype=dtype,
                                             device="meta"))
    assert tchol.micro_chol_inv.launches == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1, 2, 31, 128, "max"])
def test_plain_matches_pallas_at_panel_widths(p, dtype):
    """The plain version against the JAX kernel in interpret mode and
    NumPy at the widths the kernel must cover, up to its largest p."""
    if p == "max":
        p = tchol.max_panel(torch.from_numpy(np.zeros(1, dtype)).dtype)
    A = _spd_batch(3, p, seed=p, dtype=dtype)
    jL, jinv = jchol.micro_chol_inv(jnp.asarray(A), interpret=True)
    tL, tinv = tchol.micro_chol_inv(torch.as_tensor(A))
    L_ref = np.linalg.cholesky(A.astype(np.float64))
    inv_ref = np.linalg.inv(L_ref)
    for t, j, ref in ((tL, jL, L_ref), (tinv, jinv, inv_ref)):
        atol = ATOL[dtype] * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=atol)
        assert np.all(_strict_upper(t.numpy(), p) == 0.0)
