"""The fused method-3/4 engines and the checkpointed solves through the
port, float64 on the CPU, against the JAX package's fused engines and
``utils/checkpoint.py`` on JAX-CPU in float64, and against the port's own
host engines.

The fixture is the JAX fused tests' dirty circle (``synthetic.circle_se2(
n=64, seed=1)`` plus 6 outliers, seed 9; ``tests/test_methods.py``)
carried across with ``convert.graph_from_jax``.  Each JAX fused engine
runs once per module (its ``lax.scan`` compile is the cost).  Tolerance:
1e-9 on poses, costs, rewards and EMA residuals, as the JAX package's own
fused-against-host test; decisions, masks and visits exactly.
"""

import os

import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.io import g2o as jg2o
from slam_tpu.io import synthetic
from slam_tpu.methods.layering_fused import FusedLayeringManager as JaxF3
from slam_tpu.methods.mcts_fused import FusedMctsManager as JaxF4
from slam_tpu.utils import checkpoint as jck
from slam_tpu.utils.logging import RunLogger as JaxLogger
from slam_tpu_torch import cli, convert
from slam_tpu_torch import config as tcfg
from slam_tpu_torch.config import LayeringConfig, MctsConfig, SolverConfig
from slam_tpu_torch.methods import _fused_common as fc
from slam_tpu_torch.methods import layering_fused, mcts_fused
from slam_tpu_torch.methods.layering import LayeringManager, use_fused
from slam_tpu_torch.methods.mcts import MctsManager
from slam_tpu_torch.utils import checkpoint as tck
from slam_tpu_torch.utils.logging import RunLogger
from test_torch_host import jax_native  # noqa: F401  (fixture)

TOL = 1e-9
_SOLVER = SolverConfig(linear_solver="dense", dtype="float64")
_JSOLVER = jcfg.SolverConfig(linear_solver="dense", dtype="float64")
M3_CFG = dict(local_iters=2, max_layers=8)
M4_CFG = dict(max_layers=8)
#: name: (method, config overrides).  Method 4 at conflict_tau 0 splits
#: on every positive split value: the expand path and its window solve
#: besides everything the default tau runs (on the circle it makes one
#: layer, which the host-engine comparison covers).
CASES = {
    "m3_dense": (3, dict(eval_linear="dense")),
    "m3_schur": (3, dict(eval_linear="schur", eval_schur_blocks=4)),
    "m4_expand": (4, dict(eval_linear="dense", conflict_tau=0.0)),
    "m4_expand_schur": (4, dict(eval_linear="schur", eval_schur_blocks=4,
                                conflict_tau=0.0)),
    "m4_expand_pcg": (4, dict(eval_linear="pcg", conflict_tau=0.0)),
}


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


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for the module: a full MKL thread team beside
    the other busy test processes waits on its slowest thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def circle():
    graph, _ = synthetic.circle_se2(n=64, seed=1)
    j = graph.add_random_outliers(6, seed=9)
    return j, convert.graph_from_jax(j)


def _cfg(method, kw, jax=False):
    base = dict(M3_CFG if method == 3 else M4_CFG, **kw)
    mod = jcfg if jax else tcfg
    return (mod.LayeringConfig if method == 3 else mod.MctsConfig)(**base)


def port_fused(t, method, kw, **extra):
    cls = (layering_fused.FusedLayeringManager if method == 3
           else mcts_fused.FusedMctsManager)
    mgr = cls(t, _cfg(method, kw), _SOLVER, _TorchRecorder(), device="cpu",
              **extra)
    return mgr.run(), mgr


@pytest.fixture(scope="module")
def runs(circle):
    """Per case: (JAX fused output, its records, port fused output, its
    records)."""
    j, t = circle
    out = {}
    for name, (method, kw) in CASES.items():
        jm = (JaxF3 if method == 3 else JaxF4)(j, _cfg(method, kw, jax=True),
                                               _JSOLVER, _JaxRecorder())
        to, tm = port_fused(t, method, kw)
        out[name] = (jm.run(), jm.log.entries, to, tm.log.entries)
    return out


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


def _poses(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def same_layering(to, jo, atol=TOL):
    assert to.assignments == jo.assignments
    assert (to.best_layer, to.most_selected_layer) \
        == (jo.best_layer, jo.most_selected_layer)
    assert len(to.layers) == len(jo.layers)
    for tl, jl in zip(to.layers, jo.layers):
        np.testing.assert_array_equal(tl.mask, jl.mask)
        assert (tl.visits, tl.success, tl.last_step) \
            == (jl.visits, jl.success, jl.last_step)
        np.testing.assert_allclose(_poses(tl.poses), _poses(jl.poses),
                                   rtol=0, atol=atol)
        assert abs(tl.ema_residual - jl.ema_residual) <= atol
        assert abs(tl.total_reward - jl.total_reward) <= atol
    np.testing.assert_allclose(to.poses, jo.poses, rtol=0, atol=atol)


def same_tree(to, jo, atol=TOL):
    assert to.assignments == jo.assignments
    assert (to.best_layer, to.most_visited_layer, to.most_edges_layer) \
        == (jo.best_layer, jo.most_visited_layer, jo.most_edges_layer)
    assert list(to.layers) == list(jo.layers)
    for lid, jl in jo.layers.items():
        tl = to.layers[lid]
        assert (tl.parent, tl.visits) == (jl.parent, jl.visits)
        assert sorted(tl.children) == sorted(jl.children)
        np.testing.assert_array_equal(tl.inherited, jl.inherited)
        np.testing.assert_array_equal(tl.added, jl.added)
        np.testing.assert_allclose(_poses(tl.poses), _poses(jl.poses),
                                   rtol=0, atol=atol)
        assert abs(tl.total_reward - jl.total_reward) <= atol
    np.testing.assert_allclose(to.poses, jo.poses, rtol=0, atol=atol)


def _same(method, to, jo, atol=TOL):
    (same_layering if method == 3 else same_tree)(to, jo, atol)


# ---------------------------------------------------------------------------
# (a) against the JAX fused engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_fused_matches_the_jax_engine(runs, name):
    """Identical decisions, masks, visits and chosen layers; poses,
    rewards, EMA residuals and every logged number within 1e-9 (PCG
    included: both packages run the same CG iterations, rtol 1e-3)."""
    jo, je, to, te = runs[name]
    method = CASES[name][0]
    if method == 4:
        assert sum(tag == "expand" for tag, _ in je) > 1
    else:
        assert len(to.layers) > 2
    _same_records(je, te)
    _same(method, to, jo)
    if method == 3:
        # The fused engines count a layer's mask; the host engine counts
        # the edges assigned since the layer was made.
        assert [lay.num_edges for lay in to.layers] \
            == [lay.num_edges for lay in jo.layers]


@pytest.mark.slow
def test_fused_m3_pcg_matches_the_jax_engine(circle):
    """Method 3 on the PCG eval (rtol 1e-3, at most 64 CG iterations) in
    both packages: the same decisions, every number within 1e-9."""
    j, t = circle
    kw = dict(eval_linear="pcg")
    jm = JaxF3(j, _cfg(3, kw, jax=True), _JSOLVER, _JaxRecorder())
    jo = jm.run()
    to, tm = port_fused(t, 3, kw)
    _same_records(jm.log.entries, tm.log.entries)
    same_layering(to, jo)


def test_fused_schur_eval_shares_one_partition(circle):
    """The Schur eval is planned once per manager, over the graph."""
    _, t = circle
    _, mgr = port_fused(t, 4, dict(eval_linear="schur",
                                   eval_schur_blocks=4))
    from slam_tpu_torch.solver.schur import SchurPartition

    assert isinstance(mgr.ss.plan, SchurPartition)
    assert mgr.ss.cfg.linear_solver == "schur"
    # Per candidate: the split check's 3 solves, the commit, the reward's 2.
    assert mgr.ss.solves == 6 * len(mgr.loop_indices)


# ---------------------------------------------------------------------------
# (b) against the port's host engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,kw", [
    (3, {}), (4, {}), (4, dict(conflict_tau=0.0))])
def test_fused_matches_the_host_engine(circle, method, kw):
    """Both on the dense eval (the host engines' rule on the circle)."""
    _, t = circle
    cls = LayeringManager if method == 3 else MctsManager
    host = cls(t, _cfg(method, kw), _SOLVER, RunLogger(echo=False),
               device="cpu").run()
    fused, mgr = port_fused(t, method, kw)
    assert mgr.eval_cfg.linear_solver == "dense"
    _same(method, fused, host)


# ---------------------------------------------------------------------------
# (c) chunking and (d) checkpoint resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["m3_dense", "m4_expand"])
def test_chunking_does_not_change_a_decision(circle, runs, name):
    _, t = circle
    method, kw = CASES[name]
    small, mgr = port_fused(t, method, dict(kw, scan_chunk=3))
    assert mgr.chunks == -(-len(mgr.loop_indices) // 3)
    _same(method, small, runs[name][2], atol=0)


@pytest.mark.parametrize("name", ["m3_dense", "m4_expand"])
def test_checkpoint_resume_equals_the_uninterrupted_run(tmp_path, circle,
                                                        runs, name):
    """A run killed after two chunks resumes from its checkpoint, skips
    the finished chunks and ends where the uninterrupted run ends."""
    _, t = circle
    method, kw = CASES[name]
    kw = dict(kw, scan_chunk=3)
    mod = layering_fused if method == 3 else mcts_fused
    orig = mod._fused_chunk
    ckpt = str(tmp_path / "fused.npz")
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated preemption")
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_fused_chunk", dying)
        with pytest.raises(RuntimeError, match="preemption"):
            port_fused(t, method, kw, checkpoint_path=ckpt)
    assert os.path.exists(ckpt)
    _, meta = tck.load_checkpoint(ckpt)
    assert meta["done"] == 6

    resumed, mgr = port_fused(t, method, kw, checkpoint_path=ckpt)
    assert mgr.chunks == -(-len(mgr.loop_indices) // 3) - 2
    _same(method, resumed, runs[name][2], atol=0)
    again, mgr = port_fused(t, method, kw, checkpoint_path=ckpt)
    assert mgr.chunks == 0
    _same(method, again, runs[name][2], atol=0)


# ---------------------------------------------------------------------------
# (e) no host read inside a chunk
# ---------------------------------------------------------------------------

_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


def _watch_reads(mp, mod, on_read):
    """Wrap ``mod._fused_chunk`` so that every Tensor host read inside a
    chunk calls ``on_read(name)`` (and then reads as usual)."""
    orig = mod._fused_chunk
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def read(name):
        def fn(self, *a, **k):
            on_read(name)
            return saved[name](self, *a, **k)
        return fn

    def watched(*a, **k):
        for name in _READS:
            setattr(torch.Tensor, name, read(name))
        try:
            return orig(*a, **k)
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

    mp.setattr(mod, "_fused_chunk", watched)


@pytest.mark.parametrize("name", ["m3_dense", "m3_schur", "m4_expand",
                                  "m4_expand_schur"])
def test_no_host_read_inside_a_chunk(circle, runs, name):
    _, t = circle
    method, kw = CASES[name]
    mod = layering_fused if method == 3 else mcts_fused

    def refuse(what):
        raise AssertionError(f"host read Tensor.{what} inside a chunk")

    with pytest.MonkeyPatch.context() as mp:
        _watch_reads(mp, mod, refuse)
        out, _ = port_fused(t, method, kw)
    _same(method, out, runs[name][2], atol=0)


def test_pcg_eval_reads_its_stopping_test(circle, runs):
    """The stated exception: the PCG eval reads its CG stopping flag, every
    CHECK_EVERY CG iterations of each folded call, and nothing else (its
    count stays on the device): fewer reads than the two (the flag at
    least once, the count once) that each LM iteration of each solve
    made while every evaluation was its own call (this run: 159 reads in
    36 calls, then 353 in 72)."""
    _, t = circle
    reads = []
    with pytest.MonkeyPatch.context() as mp:
        _watch_reads(mp, mcts_fused, reads.append)
        out, mgr = port_fused(t, 4, CASES["m4_expand_pcg"][1])
    assert set(reads) == {"__bool__"}
    assert len(reads) < 2 * mgr.ss.iterations
    same_tree(out, runs["m4_expand_pcg"][2], atol=0)


# ---------------------------------------------------------------------------
# The engine rule and the chunk runner
# ---------------------------------------------------------------------------

def test_engine_rule():
    """Fused when on, when auto on CUDA, and whenever a checkpoint is
    given (the JAX rule, the card as the accelerator)."""
    for fused, device, ckpt, want in (
            ("on", "cpu", None, True), ("auto", "cuda", None, True),
            ("auto", "cpu", None, False), ("off", "cuda", None, False),
            ("off", "cpu", "x.npz", True), ("auto", None, None, True)):
        assert use_fused(fused, device, ckpt) is want, (fused, device, ckpt)
    with pytest.raises(ValueError, match="auto, on or off"):
        use_fused("yes", "cpu", None)


def test_eval_solver_rule(circle):
    """auto/schur: Schur on the card at every size, dense up to 2048
    nodes and PCG above on the CPU; eval_linear overrides; the chunk is
    64 unless named."""
    _, t = circle
    for solver, kw, want in (("auto", {}, "dense"), ("schur", {}, "dense"),
                             ("auto", dict(eval_linear="pcg"), "pcg"),
                             ("pcg", {}, "pcg"),
                             ("auto", dict(eval_linear="schur"), "schur")):
        ss, chunk = fc.setup_eval_solver(
            t, LayeringConfig(**kw), SolverConfig(linear_solver=solver,
                                                  dtype="float64"), "cpu")
        assert ss.cfg.linear_solver == want, (solver, kw)
        assert ss.cfg.robust == "none" and chunk == fc.DEFAULT_CHUNK
    big = t.__class__(poses=np.zeros((2049, 3)), edges_ij=t.edges_ij,
                      edges_meas=t.edges_meas, edges_info=t.edges_info,
                      edge_type=t.edge_type)
    ss, chunk = fc.setup_eval_solver(big, MctsConfig(scan_chunk=5),
                                     SolverConfig(dtype="float64"), "cpu")
    assert ss.cfg.linear_solver == "pcg" and chunk == 5
    assert ss.cfg.pcg_max_iters == MctsConfig().eval_pcg_max_iters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fc.setup_eval_solver(t, LayeringConfig(), SolverConfig(), "cuda")


def test_chunk_outputs_come_back_whole():
    """``to_host``: one packed copy, every field back in its dtype."""
    outs = dict(i=torch.tensor([[1, 2, 3], [4, 5, 6]]),
                f=torch.tensor([0.25, -1.5], dtype=torch.float32),
                b=torch.tensor([True, False]),
                d=torch.tensor([1e-300, np.inf], dtype=torch.float64))
    host = fc.to_host(outs)
    assert list(host) == list(outs)
    for k, v in outs.items():
        np.testing.assert_array_equal(host[k], v.numpy())
    assert host["i"].dtype == np.int64 and host["b"].dtype == bool


# ---------------------------------------------------------------------------
# (f) checkpointed solves against the JAX package
# ---------------------------------------------------------------------------

def test_checkpointing_solver_matches_the_jax_one(tmp_path, circle):
    """Chunks of 4 equal one unbroken 12-iteration call (lam0, nu0 and it0
    carry one trajectory), both packages' runs within 1e-9, and a resume at
    completion returns the checkpointed state."""
    import jax.numpy as jnp

    from slam_tpu.solver.problem import anchor_first_node as janchor, \
        edge_set_from_graph as jedges
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph

    j, t = circle
    cfg = SolverConfig(robust="dcs", linear_solver="dense", dtype="float64")
    je = jedges(j, dtype=jnp.float64, incidence=False)
    jp, _, _ = jck.CheckpointingSolver(str(tmp_path / "j.npz"), 4).run(
        jnp.asarray(j.poses), jnp.ones((je.num_edges,)), je,
        janchor(j.num_nodes, dtype=jnp.float64),
        jcfg.SolverConfig(robust="dcs", linear_solver="dense",
                          dtype="float64"), total_iters=12)
    te = edge_set_from_graph(t)
    args = (torch.as_tensor(t.poses), torch.ones(te.num_edges), te,
            anchor_first_node(t.num_nodes))
    path = str(tmp_path / "t.npz")
    p1, _, r1 = tck.CheckpointingSolver(path, 4).run(*args, cfg,
                                                     total_iters=12)
    np.testing.assert_allclose(p1.numpy(), np.asarray(jp), rtol=0, atol=TOL)
    whole = lm_fixed_iters(*args, cfg, 12)
    np.testing.assert_allclose(p1.numpy(), whole.poses.numpy(), rtol=0,
                               atol=1e-12)
    state, meta = tck.load_checkpoint(path)
    assert int(state["iteration"]) == 12 and meta == {"total_iters": 12}
    assert float(state["cost"]) == float(r1.cost)
    p2, _, r2 = tck.CheckpointingSolver(path, 4).run(*args, cfg,
                                                     total_iters=12)
    assert r2 is None
    np.testing.assert_array_equal(p2.numpy(), p1.numpy())


@pytest.fixture(scope="module")
def circle_g2o(tmp_path_factory, circle):
    path = str(tmp_path_factory.mktemp("circle") / "circle.g2o")
    jg2o.write_g2o(path, circle[0])
    return path


def _read(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("method", [0, 1, 2])
def test_cli_checkpoint_matches_the_jax_run(jax_native, tmp_path,  # noqa: F811
                                            circle_g2o, method):
    """Both CLIs with ``--checkpoint``: the text files line for line (the
    JAX side writes them with its native writer, ``jax_native``, as the
    port does), the optimised poses within TOL, the same last log line,
    and a resume at completion that runs no chunk."""
    from slam_tpu import cli as jcli
    from slam_tpu_torch.io import g2o

    argv = [circle_g2o, "0", str(method), "--max-iterations", "25"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert jcli.main(argv + ["--save-path", jdir, "--checkpoint",
                             f"{jdir}/ck.npz", "--linear-solver", "dense",
                             "--dtype", "float64"]) == 0
    targv = argv + ["--save-path", tdir, "--checkpoint", f"{tdir}/ck.npz",
                    "--device", "cpu"]
    assert cli.main(targv) == 0
    for f in ("init_nodes.txt", "init_edges.txt", "opt_edges.txt"):
        assert _read(os.path.join(tdir, f)) == _read(os.path.join(jdir, f))
    np.testing.assert_allclose(g2o.load_nodes(f"{tdir}/opt_nodes.txt"),
                               g2o.load_nodes(f"{jdir}/opt_nodes.txt"),
                               rtol=0, atol=TOL)
    want = _read(f"{jdir}/method{method}.log")[-1]
    assert want.startswith("[solve]") and "checkpointed=True" in want
    assert _read(f"{tdir}/method{method}.log")[-1] == want
    # Resume at completion: no chunk runs, the recorded cost is reported.
    assert cli.main(targv) == 0
    assert _read(f"{tdir}/method{method}.log")[-1] == want


# ---------------------------------------------------------------------------
# The CLI runs the fused-engine and checkpoint flags
# ---------------------------------------------------------------------------

_FILES = {
    1: ("init_nodes.txt", "init_edges.txt", "opt_nodes.txt",
        "opt_edges.txt", "method1.log"),
    3: ("init_nodes.txt", "init_edges.txt", "layers.txt", "opt_nodes.txt",
        "opt_nodes_method3.txt", "opt_nodes_most_selected.txt",
        "method3.log"),
    4: ("init_nodes.txt", "init_edges.txt", "opt_nodes.txt",
        "opt_nodes_most_visited.txt", "opt_nodes_most_edges.txt",
        "method4_stats.txt", "method4.log"),
}


@pytest.mark.parametrize("flags", [
    ["3", "--fused", "on"], ["4", "--fused", "on"],
    ["3", "--eval-linear", "schur"], ["4", "--scan-chunk", "16"],
    ["4", "--eval-linear", "dense"], ["1", "--checkpoint", "CKPT"],
    ["3", "--checkpoint", "CKPT"],
])
def test_cli_runs_the_fused_flags(tmp_path, circle, circle_g2o, flags):
    save = tmp_path / "save"
    flags = [str(tmp_path / "ck.npz") if f == "CKPT" else f for f in flags]
    assert cli.main([circle_g2o, "0", *flags, "--device", "cpu",
                     "--save-path", str(save)]) == 0
    method = int(flags[0])
    for f in _FILES[method]:
        assert (save / f).is_file(), f
    if method in (3, 4):
        from slam_tpu_torch.tools.manager_spread import engine_record

        eng = engine_record(_read(save / f"method{method}.log"))
        # On the CPU, auto takes the host engine unless a checkpoint is
        # given; the eval flags then have nothing to configure.
        fused = "--fused" in flags or "--checkpoint" in flags
        assert eng["fused"] == str(fused)
        if fused:
            n = int((circle[1].edge_type != 0).sum())
            chunk = int(flags[2]) if "--scan-chunk" in flags else 64
            assert int(eng["chunks"]) == -(-n // chunk)
    if "--checkpoint" in flags:
        assert os.path.isfile(flags[-1])
