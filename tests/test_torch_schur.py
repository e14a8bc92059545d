"""The port's partitioned Schur solver: host partition builder against the
JAX package's (slot maps from its one-hot selectors), and the device solve
against JAX ``schur_solve`` and the port's dense solve (float64)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.io import g2o, synthetic
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu.solver.models import SE2Model as JaxSE2
from slam_tpu.solver.partition import graph_partition
from slam_tpu_torch import convert
from slam_tpu_torch.solver import linear as tlinear
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver import schur as ts
from slam_tpu_torch.solver.models import SE2Model as TorchSE2

KW = dict(robust="dcs", dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)
LAM = 1e-3


@pytest.fixture(scope="module")
def problem():
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    g = graph.add_random_outliers(8, seed=2).canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=256,
                                incidence=False)
    te = tp.edge_set_from_graph(g, dtype=torch.float64, pad_to=256)
    jf = jp.anchor_first_node(g.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(g.num_nodes)
    poses = g.poses + np.random.default_rng(5).normal(scale=0.05,
                                                      size=g.poses.shape)
    jsys = jl.linearize(jnp.asarray(poses), jnp.ones(je.num_edges), je, jf,
                        model=JaxSE2, **KW)
    tsys = tl.linearize(torch.as_tensor(poses),
                        torch.ones(te.num_edges, dtype=torch.float64), te,
                        tf, model=TorchSE2, **KW)
    ij = np.asarray(je.ij)
    dense = tlinear.dense_solve(tsys, te, torch.tensor(LAM, dtype=torch.float64),
                                tlinear.dense_plan(te)).poses.numpy()
    return g, ij, je, te, jsys, tsys, dense


def _partitions(g, ij, kind, pad):
    kw = {}
    if kind == "spectral":
        P = 4
        kw["node_block"] = graph_partition(ij, g.num_nodes, P)
    elif kind == "cuts":
        P = 4
        kw["optimize_cuts"] = True
    else:
        P = int(kind)
    if pad:
        stats = js.partition_stats(ij, g.num_nodes, P,
                                   optimize_cuts=kw.get("optimize_cuts",
                                                        False),
                                   node_block=kw.get("node_block"))
        kw["pad_shapes"] = tuple(s + 3 for s in stats)
    jpart = js.build_partition(ij, g.num_nodes, P, dtype=jnp.float64, **kw)
    tpart = ts.build_partition(ij, g.num_nodes, P, **kw)
    return jpart, tpart


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("kind", ["2", "4", "8", "cuts", "spectral"])
def test_build_partition_equals_converted_jax(problem, kind, pad):
    g, ij, *_ = problem
    jpart, tpart = _partitions(g, ij, kind, pad)
    conv = convert.partition_from_jax(jpart)
    for name in ts.SlotMaps._fields:
        np.testing.assert_array_equal(getattr(tpart.slots, name),
                                      getattr(conv.slots, name),
                                      err_msg=name)
    for name in ("num_blocks", "ni_max", "ns", "ek_max", "es_max",
                 "nsk_max"):
        assert getattr(tpart, name) == getattr(jpart, name), name


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("kind", ["4", "8", "spectral"])
def test_schur_solve_matches_jax_and_dense(problem, monkeypatch, kind, pad,
                                           inverse):
    g, ij, je, te, jsys, tsys, dense = problem
    if not inverse:  # force the half-substitution branch in both packages
        monkeypatch.setattr(js, "_INV_MAX_DIM", 0)
        monkeypatch.setattr(ts, "_INV_MAX_DIM", 0)
    jpart, tpart = _partitions(g, ij, kind, pad)
    # A fresh jit, so tracing reads the monkeypatched switch (a cache hit
    # from another case would keep the other branch).
    jsolve = jax.jit(js.schur_solve.__wrapped__)
    jx = np.asarray(jsolve(jsys, je, jpart, jnp.asarray(LAM)).poses)
    tx = ts.schur_solve(tsys, te, tpart,
                        torch.tensor(LAM, dtype=torch.float64)).poses.numpy()
    scale = np.abs(jx).max()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(tx, dense, rtol=0, atol=1e-9 * scale)


def test_schur_solve_on_converted_partition(problem):
    g, ij, je, te, jsys, tsys, dense = problem
    jpart, _ = _partitions(g, ij, "4", False)
    tx = ts.schur_solve(tsys, te, convert.partition_from_jax(jpart),
                        torch.tensor(LAM, dtype=torch.float64)).poses
    np.testing.assert_allclose(tx.numpy(), dense, rtol=0,
                               atol=1e-9 * np.abs(dense).max())


def test_choose_partition_matches_jax(problem):
    g, ij, *_ = problem
    jP, jnb = js.choose_partition(ij, g.num_nodes)
    tP, tnb = ts.choose_partition(ij, g.num_nodes)
    assert jP == tP
    assert (jnb is None) == (tnb is None)
    if jnb is not None:
        np.testing.assert_array_equal(jnb, tnb)
    assert (js.choose_num_blocks(ij, g.num_nodes)
            == ts.choose_num_blocks(ij, g.num_nodes))


def test_intel_partition_matches_jax():
    """The main path's partition: INTEL+50 seed 42, edges padded to 1536,
    16 index blocks (the pick both packages log in the global-solve
    parity test)."""
    path = os.path.join(os.path.dirname(__file__), "..", "results", "replay",
                        "INTEL_50out_seed42.g2o")
    g = g2o.load_g2o(path).canonical_order()
    ij = np.concatenate([g.edges_ij, np.zeros((1536 - g.num_edges, 2),
                                              np.int32)])
    jpart = js.build_partition(ij, g.num_nodes, 16, dtype=jnp.float32)
    tslots = ts.build_slots(ij, g.num_nodes, 16)
    conv = convert.slots_from_jax(jpart)
    for name in ts.SlotMaps._fields:
        np.testing.assert_array_equal(getattr(tslots, name),
                                      getattr(conv, name), err_msg=name)
    assert (js.choose_num_blocks(ij, g.num_nodes)
            == ts.choose_num_blocks(ij, g.num_nodes) == 16)


def test_bad_node_block_raises():
    ij = np.array([[0, 1], [1, 2], [2, 3]])
    with pytest.raises(ValueError):
        ts.build_slots(ij, 4, 2, node_block=np.array([0, 0, 1, 2]))
    with pytest.raises(ValueError):
        ts.build_slots(ij, 4, 2, node_block=np.array([0, -1, 1, 1]))
    with pytest.raises(ValueError):
        ts.build_slots(ij, 4, 2, pad_shapes=(1, 1, 1))
