"""Methods 3 and 4 (layering, MCTS) through the port, float64 on the CPU,
against the JAX package's host engines on JAX-CPU in float64 and against
the port's copy of the manager oracle.

The fixture is the JAX tests' dirty circle (``synthetic.circle_se2(n=64,
seed=1)`` plus 6 outliers, seed 9) carried across with
``convert.graph_from_jax``; the eval solver is dense, as in
``tests/test_methods.py`` and ``tests/test_manager_oracle.py``.  Each JAX
manager runs once per module.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.io import synthetic
from slam_tpu.methods import batched as jbatched
from slam_tpu.methods.layering import LayeringManager as JaxLayering
from slam_tpu.methods.mcts import MctsManager as JaxMcts
from slam_tpu.solver import linearize as jlin
from slam_tpu.solver.problem import anchor_first_node as janchor, \
    edge_set_from_graph as jedges
from slam_tpu.utils.logging import RunLogger as JaxLogger
from slam_tpu_torch import cli, convert
from slam_tpu_torch.config import LayeringConfig, MctsConfig, RunConfig, \
    SolverConfig
from slam_tpu_torch.io import g2o
from slam_tpu_torch.methods import batched
from slam_tpu_torch.methods.layering import DENSE_MAX_NODES, \
    LayeringManager, eval_solver_config
from slam_tpu_torch.methods.mcts import MctsManager
from slam_tpu_torch.solver import linearize as tlin
from slam_tpu_torch.solver.manager_oracle import Method3Oracle, \
    Method4Oracle
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.solver.lm import lm_fixed_iters
from slam_tpu_torch.tools import manager_streams as ms
from slam_tpu_torch.tools.manager_spread import short_solve_inputs
from slam_tpu_torch.utils.logging import RunLogger

TOL = 1e-9
_SOLVER = SolverConfig(linear_solver="dense", dtype="float64")
_JSOLVER = jcfg.SolverConfig(linear_solver="dense", dtype="float64")
M3_CFG = dict(local_iters=2, max_layers=8)
M4_CFG = dict(max_layers=8)


class _Recorder:
    """Keeps every log record (tag, fields) with its raw values."""

    def __init__(self):
        self.entries = []

    def log(self, tag, msg="", **fields):
        self.entries.append((tag, fields))


class _JaxRecorder(_Recorder, JaxLogger):
    def __init__(self):
        JaxLogger.__init__(self, echo=False)
        _Recorder.__init__(self)


class _TorchRecorder(_Recorder, RunLogger):
    def __init__(self):
        RunLogger.__init__(self, echo=False)
        _Recorder.__init__(self)


@pytest.fixture(scope="module")
def circle():
    graph, _ = synthetic.circle_se2(n=64, seed=1)
    j = graph.add_random_outliers(6, seed=9)
    return j, convert.graph_from_jax(j)


def _run_pair(circle, method, **kw):
    """(JAX output, its records, port output, its records)."""
    j, t = circle
    if method == 3:
        kw = dict(M3_CFG, **kw)
        jm = JaxLayering(j, jcfg.LayeringConfig(**kw), _JSOLVER,
                         _JaxRecorder())
        tm = LayeringManager(t, LayeringConfig(**kw), _SOLVER,
                             _TorchRecorder(), device="cpu")
    else:
        kw = dict(M4_CFG, **kw)
        jm = JaxMcts(j, jcfg.MctsConfig(**kw), _JSOLVER, _JaxRecorder())
        tm = MctsManager(t, MctsConfig(**kw), _SOLVER, _TorchRecorder(),
                         device="cpu")
    return jm.run(), jm.log.entries, tm.run(), tm.log.entries


@pytest.fixture(scope="module")
def m3_nielsen(circle):
    return _run_pair(circle, 3)


@pytest.fixture(scope="module")
def m3_ceres(circle):
    return _run_pair(circle, 3, eval_trust_region="ceres")


@pytest.fixture(scope="module")
def m4(circle):
    return _run_pair(circle, 4)


@pytest.fixture(scope="module")
def m4_expand(circle):
    """Method 4 with every positive split value a split: the expand path
    and its window solve (fixed rows: the nodes no active edge touches)."""
    return _run_pair(circle, 4, conflict_tau=0.0)


def _random_poses(graph, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return graph.poses + rng.normal(scale=scale, size=graph.poses.shape)


# ---------------------------------------------------------------------------
# Edge helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("helper", ["edge_residuals", "edge_mahalanobis",
                                    "edge_info_gain"])
def test_edge_helpers_match(circle, helper):
    j, t = circle
    poses = _random_poses(j, 3)
    je = jedges(j, dtype=np.float64)
    te = edge_set_from_graph(t, dtype=torch.float64)
    if helper == "edge_info_gain":
        want, got = jlin.edge_info_gain(je), tlin.edge_info_gain(te)
    else:
        want = getattr(jlin, helper)(np.asarray(poses), je)
        got = getattr(tlin, helper)(torch.as_tensor(poses), te)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# Batched and masked short solves
# ---------------------------------------------------------------------------

def _pair_setup(circle, linear="dense", **eval_kw):
    j, t = circle
    jc = jcfg.SolverConfig(linear_solver=linear, dtype="float64",
                           robust="none", **eval_kw)
    tc = SolverConfig(linear_solver=linear, dtype="float64", robust="none",
                      **eval_kw)
    te = edge_set_from_graph(t, dtype=torch.float64)
    return (jedges(j, dtype=np.float64), jc), (te, tc,
                                                batched.eval_plan(tc, te))


def _masks(graph, rng, B):
    loop = graph.canonical_order().edge_type != 0
    return np.stack([~loop | (rng.random(loop.shape) < 0.5)
                     for _ in range(B)]).astype(np.float64)


@pytest.mark.parametrize("trust_region", ["nielsen", "ceres"])
@pytest.mark.parametrize("num_iters", [1, 2])
def test_batched_eval_cost_matches(circle, num_iters, trust_region):
    j, _ = circle
    (je, jc), (te, tc, plan) = _pair_setup(circle,
                                           trust_region=trust_region)
    rng = np.random.default_rng(11)
    masks = _masks(j, rng, 4)
    poses = np.stack([_random_poses(j, s) for s in range(4)])
    n = j.num_nodes
    want = jbatched.batched_eval_cost(
        poses, masks, je, janchor(n, dtype=np.float64), jc, num_iters)
    got = batched.batched_eval_cost(
        torch.as_tensor(poses), torch.as_tensor(masks), te,
        anchor_first_node(n), tc, num_iters, plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _window_free(graph, kind):
    """A free mask with fixed rows: method 3's commit window (radius 10,
    anchored at its first node) or method 4's nodes touched by no active
    edge."""
    n = graph.num_nodes
    if kind == "window":
        free = np.zeros(n)
        free[20:41] = 1.0
        free[20] = 0.0
        return free
    free = np.ones(n)
    free[::3] = 0.0
    return free


@pytest.mark.parametrize("kind", ["window", "scattered"])
def test_masked_solve_matches(circle, kind):
    j, _ = circle
    (je, jc), (te, tc, plan) = _pair_setup(circle)
    free = _window_free(j, kind)
    active = _masks(j, np.random.default_rng(5), 1)[0]
    if kind == "window":
        ij = j.canonical_order().edges_ij
        inside = (free > 0) | (np.arange(j.num_nodes) == 20)
        active = active * (inside[ij[:, 0]] & inside[ij[:, 1]])
    poses = _random_poses(j, 7)
    want_p, want_c = jbatched.masked_solve(poses, active, free, je, jc, 2)
    got_p, got_c = batched.masked_solve(
        torch.as_tensor(poses), torch.as_tensor(active),
        torch.as_tensor(free), te, tc, 2, plan)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=0, atol=TOL)
    # Fixed rows do not move.
    fixed = free == 0
    np.testing.assert_array_equal(got_p.numpy()[fixed], poses[fixed])


def test_batched_masked_solve_matches(circle):
    j, _ = circle
    (je, jc), (te, tc, plan) = _pair_setup(circle)
    masks = _masks(j, np.random.default_rng(8), 3)
    frees = np.stack([_window_free(j, "window"), _window_free(j, "scattered"),
                      np.asarray(janchor(j.num_nodes, np.float64).node)])
    poses = np.stack([_random_poses(j, s) for s in (1, 2, 3)])
    want_p, want_c = jbatched.batched_masked_solve(poses, masks, frees, je,
                                                   jc, 1)
    got_p, got_c = batched.batched_masked_solve(
        torch.as_tensor(poses), torch.as_tensor(masks),
        torch.as_tensor(frees), te, tc, 1, plan)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("method", [3, 4])
def test_manager_short_solve_inputs_match(circle, method):
    """The short-solve inputs a manager gives (a candidate's edge mask, a
    windowed free mask; the cases ``chip_smoke.py`` replays on the card):
    one LM iteration on them equals the JAX package's masked solve."""
    j, t = circle
    ss, cases = short_solve_inputs(t, method, "cpu", "float64", 100)
    assert set(cases) == {"candidate", "window"}
    c = ss.cfg
    jc = jcfg.SolverConfig(linear_solver=c.linear_solver, dtype="float64",
                           robust=c.robust, huber_delta=c.huber_delta,
                           trust_region=c.trust_region)
    je = jedges(j, dtype=np.float64)
    loop = j.canonical_order().edge_type != 0
    for kind, (poses, sw, edges, free) in cases.items():
        active, fn = edges.active.numpy(), free.node.numpy()
        assert (active[loop] > 0).any(), kind
        if method == 3 and kind == "window":
            assert fn.sum() < j.num_nodes - 1
        want_p, want_c = jbatched.masked_solve(poses.numpy(), active, fn,
                                               je, jc, 1)
        res = lm_fixed_iters(poses, sw, edges, free, c, 1,
                             partition=ss.plan)
        np.testing.assert_allclose(res.poses.numpy(), np.asarray(want_p),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(float(res.cost), float(want_c), rtol=0,
                                   atol=TOL)


def test_eval_cost_on_pcg_matches(circle):
    """The eval on PCG (the solver of graphs above 2048 nodes) at the
    managers' eval accuracy, against the JAX package at the same
    ``eval_pcg_*``."""
    j, t = circle
    lc = LayeringConfig()
    (je, jc), (te, tc, plan) = _pair_setup(
        circle, "pcg", pcg_rtol=lc.eval_pcg_rtol,
        pcg_max_iters=lc.eval_pcg_max_iters)
    # The single problem's PCG plan, from which a batch stacks its lanes'.
    assert plan == batched.linear.PCGPlan()
    assert eval_solver_config(_SOLVER.replace(linear_solver="pcg"), lc,
                              t.num_nodes) == tc.replace(
        huber_delta=lc.huber_delta)
    masks = _masks(j, np.random.default_rng(2), 3)
    poses = np.stack([_random_poses(j, s) for s in (4, 5, 6)])
    n = j.num_nodes
    want = jbatched.batched_eval_cost(
        poses, masks, je, janchor(n, dtype=np.float64), jc, 2)
    got = batched.batched_eval_cost(
        torch.as_tensor(poses), torch.as_tensor(masks), te,
        anchor_first_node(n), tc, 2, plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_dense_eval_needs_its_plan(circle):
    _, (te, tc, _) = _pair_setup(circle)
    n = te.num_nodes
    with pytest.raises(ValueError, match="eval_plan"):
        batched.masked_solve(torch.zeros(n, 3, dtype=torch.float64),
                             te.active, anchor_first_node(n).node, te, tc,
                             1, None)
    with pytest.raises(ValueError, match="dense solver or PCG"):
        batched.eval_plan(tc.replace(linear_solver="schur"), te)


def test_eval_solver_rule():
    """Dense up to 2048 nodes and PCG above on every device (no TPU
    switch), a named solver kept; the engines default to the card."""
    lc = LayeringConfig()
    for solver, n, want in (("auto", DENSE_MAX_NODES, "dense"),
                            ("schur", DENSE_MAX_NODES + 1, "pcg"),
                            ("pcg", 10, "pcg"), ("dense", 5000, "dense")):
        got = eval_solver_config(SolverConfig(linear_solver=solver), lc, n)
        assert got.linear_solver == want, (solver, n)
        assert got.robust == "none" and got.trust_region == "nielsen"
    for cls in (LayeringManager, MctsManager):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LayeringManager(convert.graph_from_jax(
                synthetic.circle_se2(n=8, seed=0)[0]), lc)


# ---------------------------------------------------------------------------
# The managers against the JAX host engines
# ---------------------------------------------------------------------------

def _same_records(je, te):
    """Same tags and fields in the same order; float fields within TOL,
    the rest equal."""
    assert [tag for tag, _ in te] == [tag for tag, _ in je]
    for (tag, jf), (_, tf) in zip(je, te):
        assert list(tf) == list(jf), tag
        for k, v in jf.items():
            if isinstance(v, float):
                assert abs(tf[k] - v) <= TOL, (tag, k, tf[k], v)
            else:
                assert str(tf[k]) == str(v), (tag, k, tf[k], v)


def _m3_stream(entries):
    out, cur = [], None
    for tag, f in entries:
        if tag == "uct":
            cur = dict(topk=[int(s.split("(")[0][1:])
                             for s in f["topk"].split(",")],
                       deltas=[], split=False)
        elif tag == "conflict":
            cur["deltas"].append(f["Delta"])
        elif tag == "split":
            cur["split"] = True
        elif tag == "assign":
            cur["target"] = int(f["to_layer"])
        elif tag == "residual":
            cur["r_new"] = f["r_new"]
        elif tag == "uct_update":
            out.append(cur)
            cur = None
    return out


@pytest.mark.parametrize("fixture", ["m3_nielsen", "m3_ceres"])
def test_layering_matches_jax(request, fixture):
    jo, je, to, te = request.getfixturevalue(fixture)
    js, ts = _m3_stream(je), _m3_stream(te)
    assert len(ts) == len(js) > 0
    for a, b in zip(ts, js):
        assert (a["topk"], a["split"], a["target"]) \
            == (b["topk"], b["split"], b["target"])
        np.testing.assert_allclose(a["deltas"], b["deltas"], rtol=0,
                                   atol=TOL)
        assert abs(a["r_new"] - b["r_new"]) <= TOL
    _same_records(je, te)
    assert to.assignments == jo.assignments
    assert (to.best_layer, to.most_selected_layer) \
        == (jo.best_layer, jo.most_selected_layer)
    assert len(to.layers) == len(jo.layers)
    for tl, jl in zip(to.layers, jo.layers):
        np.testing.assert_array_equal(tl.mask, jl.mask)
        np.testing.assert_allclose(tl.poses.numpy(), jl.poses, rtol=0,
                                   atol=TOL)
        assert (tl.visits, tl.success) == (jl.visits, jl.success)
        assert abs(tl.ema_residual - jl.ema_residual) <= TOL
    np.testing.assert_allclose(to.poses, jo.poses, rtol=0, atol=TOL)


@pytest.mark.parametrize("fixture", ["m4", "m4_expand"])
def test_mcts_matches_jax(request, fixture):
    jo, je, to, te = request.getfixturevalue(fixture)
    js, ts = _m4_stream(je), _m4_stream(te)
    assert len(ts) == len(js) > 0
    if fixture == "m4_expand":
        assert sum(s["action"] == "expand" for s in js) > 1
    for a, b in zip(ts, js):
        assert (a["action"], a.get("selected")) \
            == (b["action"], b.get("selected"))
        assert abs(a["residual"] - b["residual"]) <= TOL
        assert ("split_value" in a) == ("split_value" in b)
        if "split_value" in b:
            assert abs(a["split_value"] - b["split_value"]) <= TOL
    _same_records(je, te)
    assert to.assignments == jo.assignments
    assert (to.best_layer, to.most_visited_layer, to.most_edges_layer) \
        == (jo.best_layer, jo.most_visited_layer, jo.most_edges_layer)
    assert list(to.layers) == list(jo.layers)
    for lid, jl in jo.layers.items():
        tl = to.layers[lid]
        np.testing.assert_array_equal(tl.all_edges, jl.all_edges)
        np.testing.assert_allclose(tl.poses.numpy(), jl.poses, rtol=0,
                                   atol=TOL)
        assert tl.visits == jl.visits
        assert abs(tl.total_reward - jl.total_reward) <= TOL
    np.testing.assert_allclose(to.poses, jo.poses, rtol=0, atol=TOL)


def _m4_stream(entries):
    out, cur = [], None
    for tag, f in entries:
        if tag.startswith("step"):
            if cur is not None:
                out.append(cur)
            cur = dict(action=None)
        elif cur is None:
            continue
        elif tag == "residual":
            cur["residual"] = f["edge_residual"]
        elif tag == "skip":
            cur["action"] = "skip"
        elif tag == "split_check":
            cur["split_value"] = float(f["split_value"])
        elif tag == "expand":
            cur["action"] = "expand"
            cur["selected"] = f["created"]
        elif tag == "assign":
            cur["action"] = "assign"
            cur["selected"] = f["layer"]
    if cur is not None:
        out.append(cur)
    return out


# ---------------------------------------------------------------------------
# The managers against the port's copy of the manager oracle
# (tests/test_manager_oracle.py's gates and tolerances)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture,atol", [("m3_nielsen", 2e-4),
                                          ("m3_ceres", 5e-5)])
def test_layering_tracks_the_oracle(request, circle, fixture, atol):
    _, t = circle
    _, _, out, entries = request.getfixturevalue(fixture)
    oracle = Method3Oracle(t, LayeringConfig(**M3_CFG))
    dec = oracle.run()
    host = _m3_stream(entries)
    assert len(host) == len(dec)
    for h, o in zip(host, dec):
        assert (h["topk"], h["split"], h["target"]) \
            == (o["topk"], o["split"], o["target"])
        np.testing.assert_allclose(h["deltas"], o["deltas"], atol=atol)
    assert out.best_layer == oracle.best_layer()
    assert out.assignments == oracle.assignments


def test_mcts_tracks_the_oracle(circle, m4):
    _, t = circle
    _, _, out, entries = m4
    oracle = Method4Oracle(t, MctsConfig(**M4_CFG))
    dec = oracle.run()
    host = _m4_stream(entries)
    assert len(host) == len(dec)
    for h, o in zip(host, dec):
        assert h["action"] == o["action"]
        if h["action"] != "skip":
            assert h["selected"] in (o["selected"], o.get("child"))
        np.testing.assert_allclose(h["residual"], o["residual"], atol=2e-3)
        if "split_value" in h:
            np.testing.assert_allclose(h["split_value"], o["split_value"],
                                       atol=2e-4)
    assert out.best_layer == oracle.best_layer()


# ---------------------------------------------------------------------------
# run_from_config, the CLI, and the decision-stream tools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(circle, tmp_path_factory):
    """The circle written as a g2o file, then methods 3 and 4 through both
    packages' ``run_from_config`` (same configuration)."""
    from slam_tpu.methods import layering as jl, mcts as jm
    from slam_tpu_torch.methods import layering as tl, mcts as tm

    root = tmp_path_factory.mktemp("artifacts")
    path = str(root / "circle.g2o")
    g2o.write_g2o(path, circle[1])
    out = {}
    for method, jrun, trun in ((3, jl.run_from_config, tl.run_from_config),
                               (4, jm.run_from_config, tm.run_from_config)):
        kw = dict(dataset=path, num_outliers=0, method=method)
        jc = jcfg.RunConfig(save_path=str(root / f"jax{method}"),
                            solver=_JSOLVER,
                            layering=jcfg.LayeringConfig(**M3_CFG),
                            mcts=jcfg.MctsConfig(**M4_CFG), **kw)
        tc = RunConfig(save_path=str(root / f"port{method}"),
                       solver=_SOLVER, layering=LayeringConfig(**M3_CFG),
                       mcts=MctsConfig(**M4_CFG), **kw)
        out[method] = (jrun(jc, fused="off"), jc.save_path,
                       trun(tc, device="cpu"), tc.save_path)
    return out


def _read(path):
    with open(path) as f:
        return f.read().splitlines()


def test_method3_artifacts_match(artifacts):
    jo, jdir, to, tdir = artifacts[3]
    for f in ("init_nodes.txt", "init_edges.txt", "layers.txt",
              "opt_nodes.txt", "opt_nodes_method3.txt",
              "opt_nodes_most_selected.txt", "method3.log",
              "plot_best.png", "plot_most_selected.png"):
        assert os.path.isfile(os.path.join(tdir, f)), f
    for f in ("layers.txt", "init_nodes.txt", "init_edges.txt"):
        assert _read(os.path.join(tdir, f)) == _read(os.path.join(jdir, f))
    for f in ("opt_nodes.txt", "opt_nodes_most_selected.txt"):
        np.testing.assert_allclose(g2o.load_nodes(os.path.join(tdir, f)),
                                   g2o.load_nodes(os.path.join(jdir, f)),
                                   rtol=0, atol=1e-6)
    text = "\n".join(_read(os.path.join(tdir, "method3.log")))
    for tag in ("[init]", "[uct]", "[conflict]", "[assign]", "[residual]",
                "[uct_update]", "[finish]", "[summary]", "[engine]"):
        assert tag in text, tag
    assert to.assignments == jo.assignments


def test_method4_artifacts_match(artifacts):
    jo, jdir, to, tdir = artifacts[4]
    for f in ("opt_nodes.txt", "opt_nodes_most_visited.txt",
              "opt_nodes_most_edges.txt", "method4_stats.txt",
              "method4.log", "method4_comparison.png"):
        assert os.path.isfile(os.path.join(tdir, f)), f
    got = _read(os.path.join(tdir, "method4_stats.txt"))
    want = _read(os.path.join(jdir, "method4_stats.txt"))
    assert got[0] == want[0] == (
        "# layer_id visits total_reward avg_reward normalized_reward "
        "total_edges inherited_edges added_edges")
    assert len(got) == len(want) > 1
    for g_row, w_row in zip(got[1:], want[1:]):
        g_f, w_f = g_row.split(), w_row.split()
        assert [g_f[i] for i in (0, 1, 5, 6, 7)] \
            == [w_f[i] for i in (0, 1, 5, 6, 7)]
        np.testing.assert_allclose([float(v) for v in g_f[2:5]],
                                   [float(v) for v in w_f[2:5]], rtol=0,
                                   atol=TOL)
    text = "\n".join(_read(os.path.join(tdir, "method4.log")))
    for tag in ("[init]", "[residual]", "[split_check]", "[reward]",
                "[backprop]", "[summary]", "[engine]"):
        assert tag in text, tag
    assert to.assignments == jo.assignments
    assert to.best_layer == jo.best_layer


@pytest.mark.parametrize("method", [3, 4])
def test_cli_runs_the_managers_on_cpu(tmp_path, circle, method):
    path = str(tmp_path / "circle.g2o")
    g2o.write_g2o(path, circle[1])
    save = tmp_path / "save"
    assert cli.main([path, "0", str(method), "--device", "cpu",
                     "--eval-trust-region", "ceres", "--save-path",
                     str(save)]) == 0
    lines = _read(save / f"method{method}.log")
    from slam_tpu_torch.tools.manager_spread import engine_record

    eng = engine_record(lines)
    assert (eng["device"], eng["dtype"], eng["linear_solver"]) \
        == ("cpu", "float64", "dense")
    assert int(eng["short_solves"]) > 0
    recs = (ms.parse_m3_log if method == 3 else ms.parse_m4_log)(lines)
    assert len(recs) == int((circle[1].edge_type != 0).sum())
    assert ms.best_layer(lines, method).startswith("L")


def test_cli_eval_overrides():
    args = cli.build_parser().parse_args(
        ["INTEL", "0", "3", "--eval-trust-region", "ceres",
         "--eval-pcg-iters", "9", "--eval-pcg-rtol", "0.01"])
    cfg = cli.config_from_args(args)
    for c in (cfg.layering, cfg.mcts):
        assert (c.eval_trust_region, c.eval_pcg_max_iters,
                c.eval_pcg_rtol) == ("ceres", 9, 0.01)
    plain = cli.config_from_args(cli.build_parser().parse_args(
        ["INTEL", "0", "4"]))
    assert (plain.layering, plain.mcts) == (LayeringConfig(), MctsConfig())


def test_stream_diffs_find_the_first_divergence(circle, m3_nielsen, m4):
    """The chip gates' diffs: a stream against itself is identical; one
    flipped decision is the first divergence."""
    _, t = circle
    d3 = ms.compact_m3(Method3Oracle(t, LayeringConfig(**M3_CFG)).run())
    d4 = ms.compact_m4(Method4Oracle(t, MctsConfig(**M4_CFG)).run())
    r3 = ms.diff_m3(d3, d3, 0.5)
    r4 = ms.diff_m4(d4, d4, 0.3)
    assert r3["identical_prefix"] == len(d3) and r3["divergences"] == 0
    assert r4["identical_prefix"] == len(d4) and r4["divergences"] == 0
    assert r3["max_delta_diff"] == 0.0
    flipped = [dict(d) for d in d3]
    flipped[5]["split"] = not flipped[5]["split"]
    r = ms.diff_m3(flipped, d3, 0.5)
    assert r["identical_prefix"] == 5 and r["first_divergence"]["edge"] == 5


def _intel_slice():
    """``scripts/manager_oracle_check.py::intel_slice`` in the port's types:
    the INTEL prefix holding the first 40 closures, plus 4 outliers."""
    from slam_tpu_torch.graph import PoseGraph

    g = g2o.load_g2o(g2o.find_dataset("INTEL"))
    ij, et = np.asarray(g.edges_ij), np.asarray(g.edge_type)
    closures = np.where(et != 0)[0]
    maxn = int(ij[closures[:40]].max()) + 1
    keep = (ij[:, 0] < maxn) & (ij[:, 1] < maxn)
    sub = PoseGraph(poses=np.asarray(g.poses)[:maxn], edges_ij=ij[keep],
                    edges_meas=np.asarray(g.edges_meas)[keep],
                    edges_info=np.asarray(g.edges_info)[keep],
                    edge_type=et[keep])
    return sub.add_random_outliers(4, seed=7)


@pytest.mark.slow
def test_manager_oracle_intel_slice_through_the_port(tmp_path):
    """``tests/test_manager_oracle.py::test_manager_oracle_intel_slice``
    through the port (298 nodes, 48 candidates, f64 dense on the CPU):
    zero divergences, and the numeric differences far below the closest
    decision margin."""
    g = _intel_slice()
    assert g.num_nodes == 298
    streams = {}
    for method, cls, cfg in ((3, LayeringManager, LayeringConfig()),
                             (4, MctsManager, MctsConfig())):
        path = str(tmp_path / f"method{method}.log")
        cls(g, cfg, _SOLVER, RunLogger(path, echo=False), device="cpu").run()
        with open(path) as f:
            lines = f.read().splitlines()
        streams[method] = (ms.parse_m3_log if method == 3
                           else ms.parse_m4_log)(lines)
    d3 = Method3Oracle(g, LayeringConfig()).run()
    d4 = Method4Oracle(g, MctsConfig()).run()
    assert len(d3) == 48
    r3 = ms.diff_m3(streams[3], ms.compact_m3(d3),
                    LayeringConfig().conflict_tau)
    r4 = ms.diff_m4(streams[4], ms.compact_m4(d4), MctsConfig().conflict_tau)
    assert r3["divergences"] == 0 and not r3["count_mismatch"]
    assert r4["divergences"] == 0 and not r4["count_mismatch"]
    assert r3["max_delta_diff"] < 1e-4 < r3["min_split_margin"]
    assert r4["max_split_value_diff_pre_divergence"] < 1e-4 \
        < r4["min_split_margin"]
