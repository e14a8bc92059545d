"""SE(3) in the port against the JAX package, float64 on the CPU: every
``geometry/se3`` function (1e-12), ``SE3Model``'s Jacobians against the
JAX ``jacfwd`` (1e-10), padded SE(3) edge sets, ``lm_fixed_iters`` on a
synthetic sphere with corrupted closures under every ported solver (cost
and poses to 1e-9), and the CLI on an SE(3) ``.g2o`` file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import cli as jcli
from slam_tpu.config import SolverConfig
from slam_tpu.geometry import se3 as jse3
from slam_tpu.io import g2o as jg2o
from slam_tpu.io import synthetic
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu.solver.linearize import cost_only as jcost
from slam_tpu.solver.models import SE3Model as JModel
from slam_tpu_torch import cli as tcli
from slam_tpu_torch import convert
from slam_tpu_torch.geometry import se3 as tse3
from slam_tpu_torch.ops import chol as tchol
from slam_tpu_torch.solver import lm as tlm
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver.linearize import cost_only as tcost
from slam_tpu_torch.solver.models import SE3Model as TModel
from slam_tpu_torch.solver.models import model_for_dim
from test_torch_host import jax_native  # noqa: F401  (fixture)

ITERS = 8


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's large dense float64 solves:
    beside other busy test processes, a full-width thread team waits on
    its slowest thread at every barrier of the factor and the triangular
    solves (a 7.6 s cell took 263 s that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _poses(rng, n, w_sign=None):
    t = rng.normal(size=(n, 3))
    q = rng.normal(size=(n, 4))
    if w_sign is not None:
        q[:, 0] = w_sign * np.abs(q[:, 0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([t, q], axis=1)


def _near_identity(rng, n, scale):
    """Poses whose rotation is ``scale`` radians or less from the identity,
    half of them with ``qw < 0`` (the same rotations)."""
    th = rng.normal(size=(n, 3)) * scale
    q = np.array(jse3.quat_exp(jnp.asarray(th)))
    q[::2] *= -1.0
    return np.concatenate([rng.normal(size=(n, 3)), q], axis=1)


@pytest.fixture(scope="module")
def pose_sets():
    rng = np.random.default_rng(0)
    pa = np.concatenate([_poses(rng, 16), _poses(rng, 16, -1.0),
                         _near_identity(rng, 16, 1e-7),
                         _near_identity(rng, 16, 1e-3)])
    pb = np.concatenate([_poses(rng, 16), _poses(rng, 16, 1.0),
                         _near_identity(rng, 16, 1e-7),
                         _near_identity(rng, 16, 1e-3)])
    meas = _poses(rng, pa.shape[0])
    # Exact measurements: the residual's rotation is the identity, w = 1.
    exact = np.asarray(jse3.relative(jnp.asarray(pa), jnp.asarray(pb)))
    meas[::3] = exact[::3]
    xi = np.concatenate([rng.normal(size=(32, 6)),
                         rng.normal(size=(16, 6)) * 1e-7,
                         np.zeros((16, 6))])
    return pa, pb, meas, xi


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


# (function, its numpy arguments made from the pose sets)
FUNCS = {
    "quat_mul": lambda pa, pb, m, xi: (pa[:, 3:], pb[:, 3:]),
    "quat_conj": lambda pa, pb, m, xi: (pa[:, 3:],),
    "quat_rotate": lambda pa, pb, m, xi: (pa[:, 3:], pb[:, :3]),
    "quat_exp": lambda pa, pb, m, xi: (xi[:, 3:],),
    "quat_log": lambda pa, pb, m, xi: (pa[:, 3:],),
    "quat_normalize": lambda pa, pb, m, xi: (pa[:, 3:] * 1.7,),
    "compose": lambda pa, pb, m, xi: (pa, pb),
    "inverse": lambda pa, pb, m, xi: (pa,),
    "relative": lambda pa, pb, m, xi: (pa, pb),
    "retract": lambda pa, pb, m, xi: (pa, xi),
    "residual": lambda pa, pb, m, xi: (pa, pb, m),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_se3_function_matches(pose_sets, name):
    args = FUNCS[name](*pose_sets)
    want = np.asarray(getattr(jse3, name)(*_j(*args)))
    got = getattr(tse3, name)(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["quat_exp", "quat_log"])
def test_maps_differentiate_at_zero_like_jax(name):
    """The tangent of exp at theta = 0 and of log at the identity (w = 1
    exactly: the clip's tie) agree with JAX's."""
    x = np.zeros((1, 3)) if name == "quat_exp" else \
        np.array([[1.0, 0.0, 0.0, 0.0]])
    jj = np.asarray(jax.jacfwd(getattr(jse3, name))(jnp.asarray(x)))
    tj = torch.func.jacfwd(getattr(tse3, name))(torch.as_tensor(x)).numpy()
    assert np.isfinite(tj).all()
    np.testing.assert_allclose(tj, jj, rtol=0, atol=1e-12)


def test_se3_model_jacobians_match_jacfwd(pose_sets):
    pa, pb, meas, _ = pose_sets
    want = JModel.residual_and_jacobians(*_j(pa, pb, meas))
    got = TModel.residual_and_jacobians(*_t(pa, pb, meas))
    for name, w, g in zip(("e", "Ja", "Jb"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10, err_msg=name)


def test_se3_model_keeps_float32(pose_sets):
    """The Jacobians come out in the poses' dtype (forward-mode AD can
    promote a float32 tangent to float64)."""
    pa, pb, meas, _ = pose_sets
    out = TModel.residual_and_jacobians(
        *(x.to(torch.float32) for x in _t(pa, pb, meas)))
    assert [x.dtype for x in out] == [torch.float32] * 3


def test_model_for_dim():
    assert model_for_dim(7) is TModel
    assert model_for_dim(3).tangent_dim == 3
    with pytest.raises(ValueError):
        model_for_dim(4)


# ---------------------------------------------------------------------------
# Edge sets and the LM loop on a synthetic sphere
# ---------------------------------------------------------------------------

def _corrupted_sphere(n=120, rings=8, bad=6):
    graph, gt = synthetic.sphere_se3(n=n, rings=rings, seed=0)
    g = graph.canonical_order()
    meas = g.edges_meas.copy()
    rng = np.random.default_rng(5)
    loop_idx = np.where(g.edge_type != 0)[0]
    pick = rng.choice(loop_idx, size=bad, replace=False)
    meas[pick, :3] += rng.normal(0, 20.0, (bad, 3))
    etype = g.edge_type.copy()
    etype[pick] = 2
    return dataclasses.replace(g, edges_meas=meas,
                               edge_type=etype).canonical_order(), gt


@pytest.fixture(scope="module")
def sphere():
    g, _ = _corrupted_sphere()
    pad_to = -(-g.num_edges // 256) * 256
    assert pad_to > g.num_edges
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float64, pad_to=pad_to)
    jpart = js.build_partition(np.asarray(je.ij), g.num_nodes, 4,
                               dtype=jnp.float64)
    return dict(g=g, je=je, te=te, jpart=jpart,
                tpart=convert.partition_from_jax(jpart),
                jf=jp.anchor_first_node(g.num_nodes, dtype=jnp.float64),
                tf=tp.anchor_first_node(g.num_nodes))


def test_padded_se3_edge_set(sphere):
    """Padded SE(3) measurements hold the identity quaternion, as in the
    JAX package, so every robust mode prices the padded set finitely."""
    te, je, g = sphere["te"], sphere["je"], sphere["g"]
    E = g.num_edges
    assert te.meas.shape == (te.num_edges, 7) and te.info.shape[1] == 21
    assert te.tangent_dim == 6
    np.testing.assert_array_equal(te.meas.numpy(), np.asarray(je.meas))
    np.testing.assert_array_equal(te.meas[E:, 3].numpy(), 1.0)
    p = g.poses
    for robust in ("none", "dcs", "sc", "sc_varpro"):
        kw = dict(model=TModel, robust=robust, dcs_phi=0.5,
                  huber_delta=0.01, sc_prior_lambda=1.0)
        t = float(tcost(torch.as_tensor(p), torch.ones(te.num_edges,
                        dtype=torch.float64), te, **kw))
        j = float(jcost(jnp.asarray(p), jnp.ones(je.num_edges), je,
                        **dict(kw, model=JModel)))
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=1e-12)


LM_CASES = {
    "dcs_dense": dict(robust="dcs", linear_solver="dense"),
    "none_dense": dict(robust="none", linear_solver="dense"),
    "dcs_schur": dict(robust="dcs", linear_solver="schur"),
    "dcs_schur_blocked": dict(robust="dcs", linear_solver="schur",
                              schur_blocked=True, schur_panel=128),
    "dcs_schur_blocked_micro": dict(robust="dcs", linear_solver="schur",
                                    schur_blocked=True, schur_panel=128,
                                    schur_pallas_micro=True),
    "dcs_pcg": dict(robust="dcs", linear_solver="pcg"),
    "sc_dense_joint": dict(robust="sc", linear_solver="dense"),
    "sc_schur": dict(robust="sc", linear_solver="schur"),
}


def _fixed_iters(c, cfg, dtype=np.float64):
    schur = cfg.linear_solver == "schur"
    E = c["je"].num_edges
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    j = jlm.lm_fixed_iters(jnp.asarray(c["g"].poses, jdt), jnp.ones(E, jdt),
                           c["je"], c["jf"], cfg, ITERS, model=JModel,
                           partition=c["jpart"] if schur else None)
    t = tlm.lm_fixed_iters(torch.as_tensor(c["g"].poses),
                           torch.ones(E, dtype=torch.float64), c["te"],
                           c["tf"], convert.config_from_jax(cfg), ITERS,
                           model=TModel,
                           partition=c["tpart"] if schur else None)
    return j, t


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_fixed_iters_matches(sphere, case):
    cfg = SolverConfig(dtype="float64", use_pallas="off", **LM_CASES[case])
    j, t = _fixed_iters(sphere, cfg)
    assert int(t.accepted) == int(j.accepted) > 0
    np.testing.assert_allclose(float(t.initial_cost), float(j.initial_cost),
                               rtol=1e-12)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-9)
    assert float(t.cost) < float(t.initial_cost)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t.switches.numpy(), np.asarray(j.switches),
                               rtol=1e-9, atol=1e-9)
    qn = np.linalg.norm(t.poses.numpy()[:, 3:], axis=1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-12)


def test_blocked_micro_float32_runs_the_kernel_path(sphere, monkeypatch):
    """In float32 the blocked factorisation takes ``micro_chol_inv`` (its
    plain version on the CPU) for the 4 interiors, which the JAX package
    leaves to the native panel factor (its TPU kernel wants 8 or more):
    the two agree to float32 rounding."""
    calls = []
    plain = tchol.micro_chol_inv_plain

    def counted(A):
        calls.append(tuple(A.shape))
        return plain(A)

    monkeypatch.setattr(tchol, "micro_chol_inv_plain", counted)
    c = sphere
    g = c["g"]
    je = jp.edge_set_from_graph(g, dtype=jnp.float32,
                                pad_to=c["je"].num_edges, incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float32,
                                pad_to=c["te"].num_edges)
    jpart = js.build_partition(np.asarray(je.ij), g.num_nodes, 4,
                               dtype=jnp.float32)
    cfg = SolverConfig(robust="dcs", linear_solver="schur", dtype="float32",
                       schur_blocked=True, schur_panel=128,
                       schur_pallas_micro=True, use_pallas="off")
    E = je.num_edges
    j = jlm.lm_fixed_iters(jnp.asarray(g.poses, jnp.float32),
                           jnp.ones(E, jnp.float32), je,
                           jp.anchor_first_node(g.num_nodes,
                                                dtype=jnp.float32),
                           cfg, 5, model=JModel, partition=jpart)
    t = tlm.lm_fixed_iters(torch.as_tensor(g.poses),
                           torch.ones(E, dtype=torch.float32), te,
                           tp.anchor_first_node(g.num_nodes,
                                                dtype=torch.float32),
                           convert.config_from_jax(cfg), 5, model=TModel,
                           partition=convert.partition_from_jax(
                               jpart, dtype=torch.float32))
    assert calls and all(s[0] == 4 and s[1] == 128 for s in calls)
    assert t.cost.dtype == torch.float32
    assert int(t.accepted) == int(j.accepted) > 0
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-4)


# ---------------------------------------------------------------------------
# The CLI on an SE(3) .g2o file
# ---------------------------------------------------------------------------

def _read_rows(path):
    with open(path) as f:
        return [line.split() for line in f]


@pytest.mark.parametrize("method", [0, 1])
def test_cli_se3_matches_jax_cli(jax_native, tmp_path, method):  # noqa: F811
    """The same SE(3) file through both CLIs: ``init_*`` files byte-equal,
    ``opt_nodes.txt`` in the same format and within 1e-9 of the JAX
    package's poses."""
    graph, _ = synthetic.sphere_se3(n=120, rings=8, seed=0)
    path = str(tmp_path / "sphere.g2o")
    jg2o.write_g2o(path, graph)
    args = [path, "6", str(method), "--seed", "3", "--max-iterations", "15"]
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    assert jcli.main(args + ["--save-path", str(dj)]) == 0
    assert tcli.main(args + ["--device", "cpu", "--save-path",
                             str(dt)]) == 0
    for name in ("init_nodes.txt", "init_edges.txt", "opt_edges.txt"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name
    rj, rt = _read_rows(dj / "opt_nodes.txt"), _read_rows(dt / "opt_nodes.txt")
    assert [len(r) for r in rt] == [len(r) for r in rj] == [8] * len(rj)
    assert [r[0] for r in rt] == [r[0] for r in rj]
    np.testing.assert_allclose(np.array(rt, float), np.array(rj, float),
                               rtol=0, atol=1e-9)
