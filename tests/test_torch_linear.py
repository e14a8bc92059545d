"""The port's switch system and iterative solver against the JAX package's,
float64 on the CPU: the damped diagonal, the switch elimination and its
back-substitution, the dense joint solve (with and without bucket-padding
self-loop edges), the matvec, the 3x3 block inverse and PCG with both
preconditioners; 1e-10 relative.  Also the exactness of the elimination:
the joint system's pose block solves the reduced system and its switch
block is the back-substitution of the pose block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.solver import linear as jlin
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import problem as jp
from slam_tpu.solver.models import SE2Model as JaxSE2
from slam_tpu_torch import convert
from slam_tpu_torch.ops import gather
from slam_tpu_torch.solver import linear as tlin
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver.models import SE2Model as TorchSE2

KW = dict(dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)
LAM = 3e-3


def _rel_close(t, j, rtol=1e-10, err_msg=""):
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(np.asarray(t), j, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _case(graph, robust, pad_to):
    g = graph.canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float64, pad_to=pad_to)
    jf = jp.anchor_first_node(g.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(g.num_nodes)
    rng = np.random.default_rng(5)
    poses = g.poses + rng.normal(scale=0.05, size=g.poses.shape)
    sw = rng.uniform(0.2, 1.0, size=je.num_edges)
    js = jl.linearize(jnp.asarray(poses), jnp.asarray(sw), je, jf,
                      model=JaxSE2, robust=robust, **KW)
    ts = tl.linearize(torch.as_tensor(poses), torch.as_tensor(sw), te, tf,
                      model=TorchSE2, robust=robust, **KW)
    return dict(g=g, je=je, te=te, js=js, ts=ts, n=g.num_nodes,
                E=je.num_edges)


@pytest.fixture(scope="module")
def sc_padded(circle_outliers):
    """Joint SC at perturbed poses and random switches; the edge list ends
    in inactive (0, 0) self-loops."""
    return _case(circle_outliers[0], "sc", 256)


@pytest.fixture(scope="module")
def sc_unpadded(circle_outliers):
    return _case(circle_outliers[0], "sc", None)


@pytest.fixture(scope="module", params=["sc_padded", "sc_unpadded"])
def sc_case(request):
    return request.getfixturevalue(request.param)


@pytest.fixture(scope="module")
def dcs_case(circle_outliers):
    return _case(circle_outliers[0], "dcs", 256)


def _lam(dtype=torch.float64):
    return jnp.asarray(LAM, jnp.float64), torch.tensor(LAM, dtype=dtype)


def test_damped_diag_matches(sc_case):
    jlam, tlam = _lam()
    for t, j, name in zip(tlin.damped_diag(sc_case["ts"], tlam),
                          jlin._damped_diag(sc_case["js"], jlam),
                          ("Hd", "Hss")):
        _rel_close(t, j, err_msg=name)


def test_eliminate_switches_matches(sc_case):
    jlam, tlam = _lam()
    jred, jback = jlin.eliminate_switches(sc_case["js"], sc_case["je"], jlam)
    tred, tback = tlin.eliminate_switches(sc_case["ts"], sc_case["te"], tlam)
    assert tred._fields == jred._fields
    for name in jred._fields:
        _rel_close(getattr(tred, name), getattr(jred, name), err_msg=name)
    xp = np.random.default_rng(1).normal(size=(sc_case["n"], 3))
    _rel_close(tback(torch.as_tensor(xp)), jback(jnp.asarray(xp)),
               err_msg="backsub")


def _joint_matrix(ts, te, Hd, Hss, n, E):
    """The damped joint matrix, column by column through the matvec."""
    dim = 3 * n + E
    cols = []
    for i in range(dim):
        z = torch.zeros(dim, dtype=torch.float64)
        z[i] = 1.0
        y = tlin.matvec(ts, te, Hd, Hss,
                        tlin.Update(z[:3 * n].reshape(n, 3), z[3 * n:]))
        cols.append(torch.cat([y.poses.reshape(-1), y.switches]))
    return torch.stack(cols, dim=1).numpy()


def test_switch_elimination_exact_algebra(sc_case):
    """The elimination is the exact Schur complement of the damped joint
    system onto the poses."""
    ts, te, n, E = sc_case["ts"], sc_case["te"], sc_case["n"], sc_case["E"]
    _, tlam = _lam()
    Hd, Hss = tlin.damped_diag(ts, tlam)
    M = _joint_matrix(ts, te, Hd, Hss, n, E)
    rhs = -np.concatenate([ts.g.numpy().ravel(), ts.gs.numpy()])
    z = np.linalg.solve(M, rhs)
    xp, xs = z[:3 * n].reshape(n, 3), z[3 * n:]
    red, back = tlin.eliminate_switches(ts, te, tlam)
    np.testing.assert_allclose(back(torch.as_tensor(xp)).numpy(), xs,
                               atol=1e-9)
    Hd_red = Hd + (red.Hdiag - ts.Hdiag)
    out = tlin.matvec(red, te, Hd_red, torch.ones(E, dtype=torch.float64),
                      tlin.Update(torch.as_tensor(xp),
                                  torch.zeros(E, dtype=torch.float64)))
    np.testing.assert_allclose(out.poses.numpy(), -red.g.numpy(), atol=1e-8)


def test_dense_joint_solve_matches(sc_case):
    jlam, tlam = _lam()
    j = jlin.dense_solve(sc_case["js"], sc_case["je"], jlam,
                         include_switches=True)
    plan = tlin.dense_plan(sc_case["te"], switches=True)
    assert isinstance(plan, tlin.JointPlan)
    t = tlin.dense_solve(sc_case["ts"], sc_case["te"], tlam, plan)
    _rel_close(t.poses, j.poses, err_msg="poses")
    _rel_close(t.switches, j.switches, err_msg="switches")


def test_dense_joint_matrix_matches_matvec(sc_case):
    """The assembled joint matrix is the matvec's operator, self-loop
    couplings added (the circle's padded edges are (0, 0) self-loops)."""
    ts, te, n, E = sc_case["ts"], sc_case["te"], sc_case["n"], sc_case["E"]
    _, tlam = _lam()
    Hd, Hss = tlin.damped_diag(ts, tlam)
    plan = tlin.dense_plan(te, switches=True)
    sel = plan.row_sel
    Sa = sel[:, :, None] * ts.Hps_a[:, None, :]
    Sb = sel[:, :, None] * ts.Hps_b[:, None, :]
    rows = torch.cat([Hd, ts.Hoff, ts.Hoff.transpose(-1, -2),
                      Hss[:, None, None] * (sel[:, :, None] * sel[:, None, :]),
                      Sa, Sa.transpose(-1, -2), Sb, Sb.transpose(-1, -2)])
    H = gather.scatter_add_rows(rows.reshape(-1, 9), plan.plan)
    dim = 3 * n + E
    np.testing.assert_allclose(H[:dim, :dim].numpy(),
                               _joint_matrix(ts, te, Hd, Hss, n, E),
                               rtol=0, atol=1e-12)
    assert not H[dim:].any() and not H[:, dim:].any()


def test_dense_pose_solve_unchanged(dcs_case):
    """Without switch unknowns the plan and the solve are the pose-only
    ones."""
    jlam, tlam = _lam()
    j = jlin.dense_solve(dcs_case["js"], dcs_case["je"], jlam)
    plan = tlin.dense_plan(dcs_case["te"])
    assert isinstance(plan, gather.SegmentPlan)
    t = tlin.dense_solve(dcs_case["ts"], dcs_case["te"], tlam, plan)
    _rel_close(t.poses, j.poses)
    assert not t.switches.any()


@pytest.mark.parametrize("case", ["sc_padded", "sc_unpadded", "dcs_case"])
def test_matvec_matches(request, case):
    c = request.getfixturevalue(case)
    jlam, tlam = _lam()
    jHd, jHss = jlin._damped_diag(c["js"], jlam)
    tHd, tHss = tlin.damped_diag(c["ts"], tlam)
    rng = np.random.default_rng(2)
    xp, xs = rng.normal(size=(c["n"], 3)), rng.normal(size=c["E"])
    j = jlin.matvec(c["js"], c["je"], jHd, jHss,
                    jlin.Update(jnp.asarray(xp), jnp.asarray(xs)))
    t = tlin.matvec(c["ts"], c["te"], tHd, tHss,
                    tlin.Update(torch.as_tensor(xp), torch.as_tensor(xs)))
    _rel_close(t.poses, j.poses, err_msg="poses")
    _rel_close(t.switches, j.switches, err_msg="switches")


@pytest.mark.parametrize("D", [3, 2, 6])
def test_inv_blocks_matches(D):
    rng = np.random.default_rng(D)
    G = rng.normal(size=(17, D, D))
    m = G @ G.transpose(0, 2, 1) + D * np.eye(D)
    t = tlin._inv_blocks(torch.as_tensor(m))
    _rel_close(t, jlin._inv_blocks(jnp.asarray(m)))
    np.testing.assert_allclose(t.numpy() @ m,
                               np.broadcast_to(np.eye(D), m.shape),
                               atol=1e-12)


def _pcg(c, preconditioner, max_iters, rtol):
    jlam, tlam = _lam()
    j, jit = jlin.pcg_solve(c["js"], c["je"], jlam, max_iters=max_iters,
                            rtol=rtol, preconditioner=preconditioner)
    t, tit = tlin.pcg_solve(c["ts"], c["te"], tlam, max_iters=max_iters,
                            rtol=rtol, preconditioner=preconditioner)
    return j, int(jit), t, tit


@pytest.mark.parametrize("preconditioner", ["tridiag", "jacobi"])
@pytest.mark.parametrize("case", ["sc_padded", "sc_unpadded", "dcs_case"])
def test_pcg_solve_matches(request, case, preconditioner):
    """To convergence: the iteration counts within one, dx to 1e-10."""
    c = request.getfixturevalue(case)
    j, jit, t, tit = _pcg(c, preconditioner, 250, 1e-8)
    assert 0 < jit < 250
    assert abs(tit - jit) <= 1, (tit, jit)
    _rel_close(t.poses, j.poses, err_msg="poses")
    _rel_close(t.switches, j.switches, err_msg="switches")


@pytest.mark.parametrize("preconditioner", ["tridiag", "jacobi"])
@pytest.mark.parametrize("max_iters", [1, 7, 9, 30])
def test_pcg_solve_fixed_iterations(sc_case, preconditioner, max_iters):
    """With ``rtol = 0`` every solve runs ``max_iters`` iterations (across
    the host's check points) and lands on the JAX package's iterate."""
    j, jit, t, tit = _pcg(sc_case, preconditioner, max_iters, 0.0)
    assert tit == jit == max_iters
    _rel_close(t.poses, j.poses, rtol=1e-9, err_msg="poses")
    _rel_close(t.switches, j.switches, rtol=1e-9, err_msg="switches")


def test_pcg_stops_where_the_test_fails(dcs_case):
    """Between two host checks the iterates freeze once the residual test
    fails: the result equals a run capped at the count JAX stops at."""
    _, jit, t, tit = _pcg(dcs_case, "tridiag", 250, 1e-8)
    assert tit == jit or abs(tit - jit) == 1
    t_cap, it_cap = tlin.pcg_solve(dcs_case["ts"], dcs_case["te"],
                                   _lam()[1], max_iters=tit, rtol=1e-8)
    assert it_cap == tit
    assert torch.equal(t_cap.poses, t.poses)
    assert torch.equal(t_cap.switches, t.switches)


def test_pcg_matvec_is_one_gather_and_one_scatter(sc_case, monkeypatch):
    """Per CG iteration the matvec makes one gather and one scatter call
    (the four node sums grouped)."""
    calls = {"gather": 0, "scatter": 0}
    real_g, real_s = tp.gather_rows, tp.scatter_add_groups

    def g(*a, **k):
        calls["gather"] += 1
        return real_g(*a, **k)

    def s(groups):
        groups = list(groups)
        calls["scatter"] += 1
        assert len(groups) <= gather.MAX_GROUPS
        return real_s(groups)

    monkeypatch.setattr(tp, "gather_rows", g)
    monkeypatch.setattr(tp, "scatter_add_groups", s)
    ts, te = sc_case["ts"], sc_case["te"]
    _, tlam = _lam()
    Hd, Hss = tlin.damped_diag(ts, tlam)
    x = tlin.Update(torch.zeros_like(ts.g), torch.zeros_like(ts.gs))
    tlin.matvec(ts, te, Hd, Hss, x)
    assert calls == {"gather": 1, "scatter": 1}


def test_schur_step_of_method2_is_the_reference_one(sc_padded):
    """Method 2 on the Schur solver follows the JAX package: the Schur
    assembly reads the Jacobians and only the diagonal of the reduced
    ``Hdiag``, so the elimination's couplings do not reach the step, which
    is then not the joint system's (ROADMAP C, reference-side fault 8).
    The port's step equals the JAX package's; the dense solve of the
    reduced system is the joint step (up to the damping of the reduced
    diagonal)."""
    from slam_tpu.config import SolverConfig
    from slam_tpu.solver import lm as jlm
    from slam_tpu.solver import schur as js
    from slam_tpu_torch.solver import lm as tlm

    c = sc_padded
    jlam, tlam = _lam()
    jpart = js.build_partition(np.asarray(c["je"].ij), c["n"], 4,
                               dtype=jnp.float64)
    cfg = SolverConfig(robust="sc", linear_solver="schur", dtype="float64")
    jdx, _ = jlm._solve_linear(c["js"], c["je"], jlam, cfg, jpart)
    tdx, _ = tlm._solve_linear(c["ts"], c["te"], tlam,
                               convert.config_from_jax(cfg),
                               convert.partition_from_jax(jpart))
    _rel_close(tdx.poses, jdx.poses, err_msg="poses")
    _rel_close(tdx.switches, jdx.switches, err_msg="switches")
    joint = tlin.dense_solve(c["ts"], c["te"], tlam,
                             tlin.dense_plan(c["te"], switches=True))
    red, _ = tlin.eliminate_switches(c["ts"], c["te"], tlam)
    reduced = tlin.dense_solve(red, c["te"], tlam, tlin.dense_plan(c["te"]))
    scale = joint.poses.abs().max().item()
    assert (reduced.poses - joint.poses).abs().max().item() < 1e-4 * scale
    assert (tdx.poses - joint.poses).abs().max().item() > 1e-2 * scale
