"""Every BlockSystem field of the port's linearisation against the JAX
package's (XLA path, float64 on the CPU), on the circle fixture with
outliers and on the INTEL+50 replay graph: 1e-10 relative."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.io import g2o
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import problem as jp
from slam_tpu.solver.models import SE2Model as JaxSE2
from slam_tpu_torch import convert
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver.models import SE2Model as TorchSE2

REPLAY = os.path.join(os.path.dirname(__file__), "..", "results", "replay",
                      "INTEL_50out_seed42.g2o")
KW = dict(dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)


def _rel_close(t, j, err_msg=""):
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(np.asarray(t), j, rtol=1e-10,
                               atol=1e-10 * scale, err_msg=err_msg)


def _both(graph, pad_to):
    g = graph.canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    te = tp.edge_set_from_graph(g, dtype=torch.float64, pad_to=pad_to)
    jf = jp.anchor_first_node(g.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(g.num_nodes)
    rng = np.random.default_rng(3)
    # Perturbed poses so every robust branch is exercised.
    poses = g.poses + rng.normal(scale=0.05, size=g.poses.shape)
    sw = rng.uniform(0.2, 1.0, size=je.num_edges)
    return g, je, te, jf, tf, poses, sw


@pytest.fixture(scope="module")
def circle_case(circle_outliers):
    return _both(circle_outliers[0], pad_to=256)


@pytest.fixture(scope="module")
def intel_case():
    return _both(g2o.load_g2o(REPLAY), pad_to=1536)


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs", "sc", "sc_varpro"])
def test_block_system_matches(request, case, robust):
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    js = jl.linearize(jnp.asarray(poses), jnp.asarray(sw), je, jf,
                      model=JaxSE2, robust=robust, **KW)
    ts = tl.linearize(torch.as_tensor(poses), torch.as_tensor(sw), te, tf,
                      model=TorchSE2, robust=robust, **KW)
    assert ts._fields == js._fields
    for name in js._fields:
        _rel_close(getattr(ts, name), getattr(js, name), err_msg=name)


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs", "sc", "sc_varpro"])
def test_cost_only_matches(request, case, robust):
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    j = jl.cost_only(jnp.asarray(poses), jnp.asarray(sw), je, model=JaxSE2,
                     robust=robust, **KW)
    t = tl.cost_only(torch.as_tensor(poses), torch.as_tensor(sw), te,
                     model=TorchSE2, robust=robust, **KW)
    _rel_close(t, j)


def test_loop_psi_matches(intel_case):
    g, je, te, jf, tf, poses, sw = intel_case
    _rel_close(tl.loop_psi(torch.as_tensor(poses), te, TorchSE2, 0.5),
               jl.loop_psi(jnp.asarray(poses), je, JaxSE2, 0.5))
    _rel_close(tl.loop_psi_mean(torch.as_tensor(poses), te, TorchSE2, 0.5),
               jl.loop_psi_mean(jnp.asarray(poses), je, JaxSE2, 0.5))


def test_edge_set_from_jax_matches_native_build(intel_case):
    g, je, te, jf, tf, poses, sw = intel_case
    conv = convert.edge_set_from_jax(je, g.num_nodes)
    for name in ("ij", "meas", "is_loop", "active", "info"):
        assert torch.equal(getattr(conv, name), getattr(te, name)), name
    for plan in ("plan_a", "plan_b"):
        for a, b in zip(getattr(conv, plan), getattr(te, plan)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
    free = convert.free_mask_from_jax(jf)
    assert torch.equal(free.node, tf.node)


def test_window_and_anchor_masks_match(intel_case):
    g, je, te, jf, tf, poses, sw = intel_case
    _rel_close(tp.window_mask(te, 100, 400), jp.window_mask(je, 100, 400))
    _rel_close(tp.anchor_node(g.num_nodes, 7).node,
               jp.anchor_node(g.num_nodes, jnp.int32(7)).node)
