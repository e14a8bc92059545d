"""The port's distributed solvers on ``torch.distributed`` against the JAX
package's (float64, CPU): gloo ranks started by the port's launcher (the
ranks import no JAX), the JAX references on ``conftest.py``'s virtual
devices in this process.  Each test of ``tests/test_distributed.py`` runs
at 2 and 4 ranks; the 8-rank cases are ``slow``.  All the jobs of one
rank count run in one launch."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import SolverConfig
from slam_tpu.io import synthetic
from slam_tpu.parallel import distributed as jdist
from slam_tpu.parallel import schur_dist as jsd
from slam_tpu.parallel.mesh import make_block_mesh, make_edge_mesh, \
    make_replica_block_mesh
from slam_tpu.solver.models import SE3Model as JSE3
from slam_tpu.solver.partition import graph_partition
from slam_tpu.solver.problem import anchor_first_node as janchor
from slam_tpu.solver.problem import edge_set_from_graph as jedges
from slam_tpu_torch import convert
from slam_tpu_torch.parallel import distributed, mesh, schur_dist
from slam_tpu_torch.solver.linearize import cost_only
from slam_tpu_torch.solver.lm import lm_fixed_iters
from slam_tpu_torch.solver.models import SE2Model
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 (virtual) JAX devices")

RANKS = [2, 4]
TOL = 1e-9
PCG = dict(linear_solver="pcg", dtype="float64", pcg_max_iters=400,
           pcg_rtol=1e-10)
DENSE = dict(linear_solver="dense", dtype="float64", use_pallas="off")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's solves: beside other busy
    test processes, a full-width thread team waits on its slowest thread
    at every barrier (as in ``tests/test_torch_ceres_oracle.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _edge_graph():
    graph, _ = synthetic.circle_se2(n=48, seed=2)
    return graph.add_random_outliers(5, seed=3)


def _schur_graph():
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    return graph.add_random_outliers(8, seed=2).canonical_order()


def _se3_graph():
    graph, _ = synthetic.sphere_se3(n=120, rings=6, radius=10.0, seed=1)
    return graph.canonical_order()


def _seed_graphs():
    base, _ = synthetic.circle_se2(n=96, seed=1)
    return [base.add_random_outliers(8, seed=s).canonical_order()
            for s in (2, 7)]


def _cases(n):
    """The jobs of one launch at ``n`` ranks, by name."""
    t = convert.config_from_jax
    tg = convert.graph_from_jax
    g = _schur_graph()
    nb = graph_partition(g.edges_ij, g.num_nodes, n)
    cases = {
        "edge_dcs": (distributed.edge_lm_job,
                     (tg(_edge_graph()), t(SolverConfig(robust="dcs", **PCG)),
                      5)),
        "edge_sc": (distributed.edge_lm_job,
                    (tg(_edge_graph()), t(SolverConfig(
                        robust="sc", **dict(PCG, pcg_rtol=1e-11))), 5)),
        "edge_multi": (distributed.edge_lm_job,
                       (tg(_edge_graph()), t(SolverConfig(
                           robust="dcs", **dict(PCG, pcg_rtol=1e-8))), 20)),
        "schur_dcs": (schur_dist.schur_lm_job,
                      (tg(g), n, t(SolverConfig(robust="dcs", **DENSE)), 8)),
        "schur_sc": (schur_dist.schur_lm_job,
                     (tg(g), n, t(SolverConfig(robust="sc", **DENSE)), 8)),
        "schur_se3": (schur_dist.schur_lm_job,
                      (tg(_se3_graph()), n,
                       t(SolverConfig(robust="dcs", **DENSE)), 6)),
        "schur_graph": (schur_dist.schur_lm_job,
                        (tg(g), n, t(SolverConfig(robust="dcs", **DENSE)), 8,
                         nb)),
        "info": (mesh.info_job, ()),
    }
    seeds = [tg(s) for s in _seed_graphs()]
    cfg = t(SolverConfig(robust="dcs", **DENSE))
    cases["batched"] = (schur_dist.batched_schur_lm_job,
                        (seeds, n // 2, cfg, 6))
    cases["rows"] = (schur_dist.replica_rows_job, (seeds, n // 2, cfg, 6))
    if n == 2:  # the seeds alone on 2 blocks, for the 2 x 2 batch
        for i, sg in enumerate(seeds):
            cases[f"seed{i}"] = (schur_dist.schur_lm_job, (sg, 2, cfg, 6))
    return cases


_RUNS = {}


def _run(n):
    """Every rank's result of every job at ``n`` ranks (one launch)."""
    if n not in _RUNS:
        cases = _cases(n)
        out = mesh.launch(n, mesh.run_jobs, list(cases.values()),
                          device="cpu", all_ranks=True)
        _RUNS[n] = {k: [r[i] for r in out] for i, k in enumerate(cases)}
    return _RUNS[n]


@pytest.fixture(scope="module")
def runs():
    return _run


def _same_on_every_rank(results, key="poses"):
    assert mesh.bitwise_equal([r[key] for r in results])
    return results[0]


def _jax_edge(n, robust, iters, **pcg):
    graph = _edge_graph()
    edges = jedges(graph, dtype=jnp.float64, incidence=False)
    free = janchor(graph.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(graph.poses, jnp.float64)
    cfg = SolverConfig(robust=robust, **dict(PCG, **pcg))
    m = make_edge_mesh(n)
    padded = jdist.pad_edges_for_mesh(edges, n)
    return jdist.distributed_lm(poses0, jdist.shard_edges(padded, m), free,
                                cfg, m, num_iters=iters), graph, cfg


def _single_pcg(graph, cfg, iters):
    g = convert.graph_from_jax(graph.canonical_order())
    e = edge_set_from_graph(g)
    return lm_fixed_iters(torch.as_tensor(g.poses),
                          torch.ones(e.num_edges, dtype=torch.float64), e,
                          anchor_first_node(g.num_nodes),
                          convert.config_from_jax(cfg), iters)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_matches_jax_and_single_process(runs, n):
    r = _same_on_every_rank(runs(n)["edge_dcs"])
    assert r["backend"] == "gloo"
    (jp, jc, jc0, _), graph, cfg = _jax_edge(n, "dcs", 5)
    np.testing.assert_allclose(r["cost0"], float(jc0), rtol=1e-12)
    np.testing.assert_allclose(r["cost"], float(jc), rtol=TOL)
    np.testing.assert_allclose(r["poses"], np.asarray(jp), rtol=0, atol=TOL)
    # The JAX test's tolerances against the single-process PCG.
    ref = _single_pcg(graph, cfg, 5)
    np.testing.assert_allclose(r["cost0"], float(ref.initial_cost),
                               rtol=1e-10)
    np.testing.assert_allclose(r["cost"], float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(r["poses"], ref.poses.numpy(), atol=1e-5)
    # One reduction per linearisation, per CG iteration and per cost.
    assert r["calls"] >= 1 + 5 * 2


@pytest.mark.parametrize("n", RANKS)
def test_distributed_reduces_cost_multi_iter(runs, n):
    r = _same_on_every_rank(runs(n)["edge_multi"])
    assert r["cost"] < 0.8 * r["cost0"]


@pytest.mark.parametrize("n", RANKS)
def test_padding_neutral(n):
    graph = convert.graph_from_jax(_edge_graph())
    edges = edge_set_from_graph(graph)
    kw = dict(model=SE2Model, robust="none", dcs_phi=0.5, huber_delta=0.01,
              sc_prior_lambda=1.0)
    poses = torch.as_tensor(graph.canonical_order().poses)
    c1 = float(cost_only(poses, torch.ones(edges.num_edges,
                                           dtype=torch.float64), edges, **kw))
    padded = distributed.pad_edges_for_mesh(edges, 8 * n + 3)
    assert padded.num_edges % (8 * n + 3) == 0
    assert padded.num_edges > edges.num_edges
    c2 = float(cost_only(poses, torch.ones(padded.num_edges,
                                           dtype=torch.float64), padded, **kw))
    assert abs(c1 - c2) < 1e-12
    np.testing.assert_array_equal(padded.ij[:edges.num_edges].numpy(),
                                  edges.ij.numpy())


def _jax_schur(g, n, robust, iters, model=None, node_block=None):
    dtype = jnp.float64
    free = janchor(g.num_nodes, dtype=dtype)
    cfg = SolverConfig(robust=robust, **DENSE)
    prob = jsd.build_dist_problem(g, n, dtype=dtype, node_block=node_block)
    return jsd.distributed_schur_lm(jnp.asarray(g.poses, dtype), free, prob,
                                    cfg, make_block_mesh(n), iters,
                                    model=model), prob


def _held_to_jax(r, j):
    jp, jc, jc0, _ = j
    np.testing.assert_allclose(r["cost0"], float(jc0), rtol=1e-12)
    np.testing.assert_allclose(r["cost"], float(jc), rtol=TOL)
    np.testing.assert_allclose(r["poses"], np.asarray(jp), rtol=0, atol=TOL)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_schur_matches_jax(runs, n):
    r = _same_on_every_rank(runs(n)["schur_dcs"])
    j, prob = _jax_schur(_schur_graph(), n, "dcs", 8)
    assert (r["ni"], r["ns"], r["ek"]) == (prob.ni, prob.ns, prob.ek)
    _held_to_jax(r, j)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_schur_sc_matches_jax(runs, n):
    """Joint SC: the per-edge switch elimination is rank-local; poses and
    the switches (per-block edge order) match the JAX run."""
    r = _same_on_every_rank(runs(n)["schur_sc"])
    j, prob = _jax_schur(_schur_graph(), n, "sc", 8)
    _held_to_jax(r, j)
    act = np.asarray(prob.edges.active) > 0
    np.testing.assert_allclose(r["switches"][act], np.asarray(j[3])[act],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_edge_sharded_sc_matches(runs, n):
    r = _same_on_every_rank(runs(n)["edge_sc"])
    (jp, jc, jc0, jsw), graph, cfg = _jax_edge(n, "sc", 5, pcg_rtol=1e-11)
    np.testing.assert_allclose(r["cost0"], float(jc0), rtol=1e-12)
    np.testing.assert_allclose(r["cost"], float(jc), rtol=1e-8)
    np.testing.assert_allclose(r["poses"], np.asarray(jp), atol=1e-8)
    ref = _single_pcg(graph, cfg, 5)
    np.testing.assert_allclose(r["cost"], float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(r["poses"], ref.poses.numpy(), atol=1e-5)
    E = ref.switches.shape[0]
    np.testing.assert_allclose(r["switches"][:E], ref.switches.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(r["switches"], np.asarray(jsw), atol=1e-8)


@pytest.mark.parametrize("n", RANKS)
def test_replica_batched_schur_matches_per_seed(runs, n):
    """2 replicas x n/2 blocks: each replica equals its seed solved alone
    on n/2 blocks (the JAX solve; the port's on each replica row's group
    in the same launch; at 2 x 2 also the port's own 2-rank runs) and the
    JAX batched solve."""
    b = _same_on_every_rank(runs(n)["batched"])
    rows = _same_on_every_rank(runs(n)["rows"])
    np.testing.assert_allclose(b["cost"], rows["cost"], rtol=1e-10)
    np.testing.assert_allclose(b["poses"], rows["poses"], rtol=0, atol=TOL)
    graphs = _seed_graphs()
    free = janchor(graphs[0].num_nodes, dtype=jnp.float64)
    cfg = SolverConfig(robust="dcs", **DENSE)
    jp, jc, jc0, _ = jsd.distributed_batched_schur_lm(
        jnp.stack([jnp.asarray(g.poses) for g in graphs]), free,
        jsd.build_dist_problem_batch(graphs, n // 2, dtype=jnp.float64), cfg,
        make_replica_block_mesh(2, n // 2), 6)
    for i, g in enumerate(graphs):
        np.testing.assert_allclose(b["cost0"][i], float(jc0[i]), rtol=1e-12)
        np.testing.assert_allclose(b["cost"][i], float(jc[i]), rtol=TOL)
        np.testing.assert_allclose(b["poses"][i], np.asarray(jp[i]), rtol=0,
                                   atol=TOL)
        alone, _ = _jax_schur(g, n // 2, "dcs", 6)
        _held_to_jax({k: b[k][i] for k in ("poses", "cost", "cost0")}, alone)
        if n == 4:
            s = _same_on_every_rank(runs(2)[f"seed{i}"])
            np.testing.assert_allclose(b["cost"][i], s["cost"], rtol=1e-10)
            np.testing.assert_allclose(b["poses"][i], s["poses"], rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("n", RANKS)
def test_init_multihost_noop_and_joined(runs, n, tmp_path, monkeypatch):
    """No process group and nothing configured: a no-op returning False;
    an explicit one-process group joins and reports False, and a second
    call is a no-op; inside the launched ranks it reports True."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_multihost() is False
    init = "file://" + str(tmp_path / "rdv")
    try:
        assert mesh.init_multihost(init, 1, 0, device="cpu") is False
        assert torch.distributed.get_world_size() == 1
        assert mesh.init_multihost(init, 1, 0, device="cpu") is False
    finally:
        torch.distributed.destroy_process_group()
    infos = runs(n)["info"]
    assert [i["rank"] for i in infos] == list(range(n))
    assert all(i["multihost"] and i["world_size"] == n
               and i["backend"] == "gloo" for i in infos)
    # The ranks run the port alone.
    assert all("slam_tpu_torch" in i["packages"]
               and not {"jax", "jaxlib", "slam_tpu"} & set(i["packages"])
               for i in infos)


@pytest.mark.parametrize("n", RANKS)
def test_dist_problem_edge_ownership(n):
    """The assignment, ``(ni, ns, ek)`` and each block's edges are the
    JAX package's bit for bit; every edge lands on one block."""
    g = _schur_graph()
    tg = convert.graph_from_jax(g)
    for nb in (None, graph_partition(g.edges_ij, g.num_nodes, n)):
        jres = jsd._assign_dist(g, n, nb)
        tres = schur_dist._assign_dist(tg, n, nb)
        np.testing.assert_array_equal(tres[0], jres[0])
        np.testing.assert_array_equal(tres[1], jres[1])
        for a, b in zip(tres[2] + tres[3], jres[2] + jres[3]):
            np.testing.assert_array_equal(a, b)
        assert schur_dist.dist_problem_stats(tg, n, nb) == \
            jsd.dist_problem_stats(g, n, nb)
        jp = jsd.build_dist_problem(g, n, dtype=jnp.float64, node_block=nb)
        tp = schur_dist.build_dist_problem(tg, n, node_block=nb)
        assert (tp.ni, tp.ns, tp.ek) == (jp.ni, jp.ns, jp.ek)
        np.testing.assert_array_equal(tp.ij, np.asarray(jp.edges.ij))
        np.testing.assert_array_equal(tp.active, np.asarray(jp.edges.active))
        assert int(tp.active.sum()) == g.num_edges
        np.testing.assert_array_equal(
            tp.int_a, np.where(np.asarray(jp.inc_int_a).sum(-1) > 0,
                               np.asarray(jp.inc_int_a).argmax(-1), -1))
        np.testing.assert_array_equal(
            tp.sep_b, np.where(np.asarray(jp.inc_sep_b).sum(-1) > 0,
                               np.asarray(jp.inc_sep_b).argmax(-1), -1))


@pytest.mark.parametrize("n", RANKS)
def test_distributed_schur_se3_matches_jax(runs, n):
    r = _same_on_every_rank(runs(n)["schur_se3"])
    j, _ = _jax_schur(_se3_graph(), n, "dcs", 6, model=JSE3)
    _held_to_jax(r, j)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_schur_graph_partition_matches_jax(runs, n):
    r = _same_on_every_rank(runs(n)["schur_graph"])
    g = _schur_graph()
    j, prob = _jax_schur(g, n, "dcs", 8,
                         node_block=graph_partition(g.edges_ij, g.num_nodes,
                                                    n))
    assert r["ns"] == prob.ns
    _held_to_jax(r, j)


def test_bad_node_block_raises():
    tg = convert.graph_from_jax(_schur_graph())
    n = tg.num_nodes
    for bad in (np.zeros(n - 1, int), np.full(n, 4), np.full(n, -1)):
        with pytest.raises(ValueError, match="node_block"):
            schur_dist.build_dist_problem(tg, 4, node_block=bad)


@pytest.mark.slow
def test_eight_ranks_match_jax():
    """The JAX tests' 8-device cases: edge-parallel DCS and the Schur
    path on contiguous and spectral blocks."""
    g = _schur_graph()
    tg = convert.graph_from_jax(g)
    cfg = convert.config_from_jax(SolverConfig(robust="dcs", **DENSE))
    nb = graph_partition(g.edges_ij, g.num_nodes, 8)
    out = mesh.launch(8, mesh.run_jobs, [
        (distributed.edge_lm_job, (convert.graph_from_jax(_edge_graph()),
                                   convert.config_from_jax(SolverConfig(
                                       robust="dcs", **PCG)), 5)),
        (schur_dist.schur_lm_job, (tg, 8, cfg, 8)),
        (schur_dist.schur_lm_job, (tg, 8, cfg, 8, nb))],
        device="cpu", all_ranks=True)
    edge, schur, spectral = ([r[i] for r in out] for i in range(3))
    (jp, jc, _, _), _, _ = _jax_edge(8, "dcs", 5)
    e = _same_on_every_rank(edge)
    np.testing.assert_allclose(e["poses"], np.asarray(jp), atol=TOL)
    _held_to_jax(_same_on_every_rank(schur), _jax_schur(g, 8, "dcs", 8)[0])
    _held_to_jax(_same_on_every_rank(spectral),
                 _jax_schur(g, 8, "dcs", 8, node_block=nb)[0])


@pytest.mark.slow
def test_dist_check_m3500_cpu():
    """``tools/dist_check`` at M3500 + 50 on 8 CPU ranks, a cut of three
    LM iterations: its gates pass."""
    from slam_tpu_torch.tools import dist_check

    assert dist_check.main(["--device", "cpu", "--iters", "3",
                            "--dtype", "float64"]) == 0


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank"):
        mesh.launch(2, mesh.run_jobs, [(os.path.join, (1,))], device="cpu")


@pytest.mark.parametrize("device, local_rank, local_ranks, cards, want", [
    (None, 3, 4, 4, ("cuda:3", "nccl")),     # torchrun, a card per rank
    ("cuda", 5, 8, 4, ("cuda:1", "gloo")),   # ranks share the cards
    ("cuda:2", 0, 1, 4, ("cuda:2", "nccl")),  # the caller's card
    ("cpu", 3, 4, 4, ("cpu", "gloo")),
])
def test_local_plan(device, local_rank, local_ranks, cards, want):
    dev, backend = mesh.local_plan(device, local_rank, local_ranks, cards)
    assert (str(dev), backend) == want


def test_init_multihost_from_torchrun_env(monkeypatch):
    """torchrun's environment: the group is joined on the device
    init_multihost chose, and every mesh carries it.  With no CUDA
    device the default (the card) raises instead of running on the
    CPU."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh, "_DEVICE", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.init_multihost()
        assert not torch.distributed.is_initialized()
    try:
        assert mesh.init_multihost(device="cpu") is False
        assert torch.distributed.get_backend() == "gloo"
        assert mesh.rank_device() == torch.device("cpu")
        for m in (mesh.make_edge_mesh(), mesh.make_block_mesh(1),
                  mesh.make_replica_block_mesh(1, 1)):
            assert m.device == torch.device("cpu")
    finally:
        torch.distributed.destroy_process_group()
