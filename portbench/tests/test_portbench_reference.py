"""The plain reference solves a small graph to its known answer, and
agrees with the port in float64 on the cells' own inputs."""

import numpy as np
import pytest
import torch

from portbench import check, generate
from portbench import cell as cells
from portbench.reference import lm as ref


def _relative(pa, pb):
    c, s = np.cos(pa[2]), np.sin(pa[2])
    d = pb[:2] - pa[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     pb[2] - pa[2]])


def _square_lane(noise: float):
    """A 12-pose loop with exact measurements (and two exact closures);
    the start poses moved by ``noise``."""
    rng = np.random.default_rng(0)
    truth = np.array([[np.cos(t) * 5, np.sin(t) * 5, t + np.pi / 2]
                      for t in np.linspace(0, 2 * np.pi, 12,
                                           endpoint=False)])
    ij = [(k, k + 1) for k in range(11)] + [(0, 11), (2, 8)]
    meas = np.array([_relative(truth[a], truth[b]) for a, b in ij])
    meas[:, 2] = np.arcsin(np.sin(meas[:, 2]))
    start = truth + noise * rng.standard_normal(truth.shape)
    start[0] = truth[0]
    loop = np.array([abs(a - b) >= 5 for a, b in ij])
    return truth, ref.Lane(start, np.array(ij), meas, loop)


@pytest.mark.parametrize("robust", ["dcs", "sc"])
def test_known_answer(robust):
    truth, lane = _square_lane(0.05)
    st = ref.Settings(robust, 0.5, 0.01, 1.0, 1e-4, 1e-12, 1e10, 40)
    r = ref.solve_lane(lane, st, "cpu")
    assert r.cost < 1e-12 < r.cost0
    np.testing.assert_allclose(r.poses.numpy(), truth, atol=1e-7)
    if robust == "sc":
        np.testing.assert_allclose(r.switches.numpy(), 1.0, atol=1e-7)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0])
    assert ref.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                          3.0]


@pytest.mark.parametrize("mix", ["dcs.b8", "sc.b8_dense"])
def test_agrees_with_port_in_float64(mix):
    """Two lanes of INTEL inputs under each traffic mix, three LM
    iterations: the port's batch in float64 on the CPU and the reference
    land on the same costs and poses."""
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch

    from portbench import program

    tr = dict(cells.traffic(mix), lanes=2, lm_iters=3)
    conf = dict(cells.load("intel50.sc.b8_dense").config, dtype="float64")
    graphs = generate.graphs(conf, tr, 7)
    prog = program.build(graphs, conf, tr, torch.device("cpu"))
    res = lm_fixed_iters_batch(*prog.batch.args, prog.cfg, 3, prog.plan)
    mine = ref.solve(check.lanes(graphs), check.settings(conf, tr), "cpu")
    for b, r in enumerate(mine):
        assert abs(float(res.initial_cost[b]) - r.cost0) <= 1e-12 * r.cost0
        assert abs(float(res.cost[b]) - r.cost) <= 1e-9 * r.cost
        assert int(res.accepted[b]) == r.accepted
        np.testing.assert_allclose(res.poses[b].numpy(), r.poses.numpy(),
                                   atol=1e-7)
