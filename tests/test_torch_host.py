"""The port's own copies of the JAX package's host modules against the
originals (INTEL, M3500; exact equality), the conversion of JAX configs
and graphs into the port's types, the port's refusal of the JAX objects
themselves, and a source scan: the port imports nothing of ``slam_tpu``."""

import dataclasses
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.eval import metrics as jmetrics
from slam_tpu.io import g2o as jg2o
from slam_tpu.robust import pcm as jpcm
from slam_tpu.solver import init as jinit
from slam_tpu.solver import partition as jpart
from slam_tpu.utils.logging import RunLogger as JaxLogger
from slam_tpu_torch import config as tcfg
from slam_tpu_torch import convert
from slam_tpu_torch.eval import metrics as tmetrics
from slam_tpu_torch.graph import PoseGraph
from slam_tpu_torch.io import g2o as tg2o
from slam_tpu_torch.methods.global_solve import setup_problem
from slam_tpu_torch.robust import pcm as tpcm
from slam_tpu_torch.solver import init as tinit
from slam_tpu_torch.solver import lm as tlm
from slam_tpu_torch.solver import partition as tpart
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.utils.logging import RunLogger as TorchLogger

REPO = pathlib.Path(__file__).resolve().parents[1]
GRAPH_FIELDS = ("poses", "edges_ij", "edges_meas", "edges_info", "edge_type")


def assert_same_graph(t, j):
    assert isinstance(t, PoseGraph)
    for name in GRAPH_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def intel():
    path = jg2o.find_dataset("INTEL")
    assert tg2o.find_dataset("INTEL") == path
    return jg2o.load_g2o(path), tg2o.load_g2o(path)


@pytest.mark.parametrize("use_native", [True, False])
def test_load_g2o_matches(use_native):
    path = jg2o.find_dataset("INTEL")
    if use_native:
        from slam_tpu_torch.io import native

        assert native.available()
    assert_same_graph(tg2o.load_g2o(path, use_native=use_native),
                      jg2o.load_g2o(path, use_native=use_native))


def test_outliers_canonical_order_match(intel):
    j, t = intel
    assert_same_graph(t.add_random_outliers(50, seed=42).canonical_order(),
                      j.add_random_outliers(50, seed=42).canonical_order())


class Capture:
    def __init__(self):
        self.records = []

    def log(self, tag, msg="", **fields):
        self.records.append(
            (tag, {k: v for k, v in fields.items() if k != "wall_s"}))


@pytest.mark.parametrize("name,outliers", [("INTEL", 50), ("M3500", 50)])
def test_apply_init_auto_matches(name, outliers):
    path = jg2o.find_dataset(name)
    j = jg2o.load_g2o(path).add_random_outliers(outliers, seed=0)
    t = tg2o.load_g2o(path).add_random_outliers(outliers, seed=0)
    lj, lt = Capture(), Capture()
    out_j = jinit.apply_init(j.canonical_order(), jcfg.RunConfig(init="auto"),
                             lj)
    out_t = tinit.apply_init(t.canonical_order(), tcfg.RunConfig(init="auto"),
                             lt)
    assert_same_graph(out_t, out_j)
    assert lt.records == lj.records
    kind = "dataset" if name == "INTEL" else "chordal"
    assert lt.records[0][1]["kind"] == kind


def test_pcm_mask_matches():
    path = jg2o.find_dataset("M3500")
    j = jg2o.load_g2o(path).add_random_outliers(50, seed=1).canonical_order()
    t = convert.graph_from_jax(j)
    rj, rt = jpcm.pcm_loop_mask(j), tpcm.pcm_loop_mask(t)
    for f in dataclasses.fields(rj):
        np.testing.assert_array_equal(getattr(rt, f.name),
                                      getattr(rj, f.name), err_msg=f.name)


def test_partition_tree_matches(intel):
    j, _ = intel
    ij = j.canonical_order().edges_ij
    lj = jpart.partition_tree(ij, j.num_nodes, max_parts=16)
    lt = tpart.partition_tree(ij, j.num_nodes, max_parts=16)
    assert sorted(lt) == sorted(lj) == [2, 4, 8, 16]
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k])


def test_metrics_match(intel):
    j, _ = intel
    golden = np.load(REPO / "results" / "golden" / "INTEL_50out_seed42.npy")
    poses = j.poses + np.random.default_rng(4).normal(scale=0.1,
                                                      size=j.poses.shape)
    for fn in ("ate", "rpe", "rpe_rot", "ate_rot", "collapse_score"):
        assert getattr(tmetrics, fn)(poses, golden) \
            == getattr(jmetrics, fn)(poses, golden), fn


def test_writers_match_byte_for_byte(intel, tmp_path):
    j, t = intel
    dj, dt = tmp_path / "j", tmp_path / "t"
    dj.mkdir()
    dt.mkdir()
    for mod, g, d in ((jg2o, j, dj), (tg2o, t, dt)):
        mod.write_nodes(str(d / "nodes.txt"), g.poses)
        mod.write_edges(str(d / "edges.txt"), g)
        mod.write_g2o(str(d / "graph.g2o"), g)
    for name in ("nodes.txt", "edges.txt", "graph.g2o"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name
    np.testing.assert_array_equal(tg2o.load_nodes(str(dt / "nodes.txt")),
                                  jg2o.load_nodes(str(dj / "nodes.txt")))


def test_run_logger_matches(tmp_path, capsys):
    fields = dict(a=1, b=0.25, c="x", d=True)
    for cls, name in ((JaxLogger, "j.log"), (TorchLogger, "t.log")):
        with cls(str(tmp_path / name), echo=True) as log:
            log.log("tag", "msg", **fields)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "[tag] msg a=1 b=0.250000 c=x d=True"
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text()


def test_config_from_jax():
    j = jcfg.RunConfig(
        dataset="M3500", num_outliers=10, method=1, seed=3, init="chordal",
        solver=jcfg.SolverConfig(dtype="float64", schur_blocked=True,
                                 schur_panel=128, schur_pallas_micro=True),
        layering=jcfg.LayeringConfig(max_layers=7),
        mcts=jcfg.MctsConfig(local_window=9))
    t = convert.config_from_jax(j)
    assert type(t) is tcfg.RunConfig
    assert type(t.solver) is tcfg.SolverConfig
    assert t == tcfg.RunConfig(
        dataset="M3500", num_outliers=10, method=1, seed=3, init="chordal",
        solver=tcfg.SolverConfig(dtype="float64", schur_blocked=True,
                                 schur_panel=128, schur_pallas_micro=True),
        layering=tcfg.LayeringConfig(max_layers=7),
        mcts=tcfg.MctsConfig(local_window=9))
    # The defaults of the two copies agree field by field.
    for name in ("SolverConfig", "RunConfig", "LayeringConfig", "MctsConfig"):
        assert convert.config_from_jax(getattr(jcfg, name)()) \
            == getattr(tcfg, name)(), name
    assert tcfg.solver_config_for_method(1) \
        == convert.config_from_jax(jcfg.solver_config_for_method(1))
    with pytest.raises(TypeError):
        convert.config_from_jax(object())


def test_graph_from_jax(intel):
    j, _ = intel
    t = convert.graph_from_jax(j)
    assert_same_graph(t, j)
    assert t.poses is not j.poses


def test_port_refuses_jax_objects(intel):
    j, t = intel
    with pytest.raises(TypeError, match="PoseGraph"):
        tp.edge_set_from_graph(j)
    with pytest.raises(TypeError, match="RunConfig"):
        setup_problem(t, jcfg.RunConfig(), device="cpu")
    with pytest.raises(TypeError, match="PoseGraph"):
        setup_problem(j, tcfg.RunConfig(), device="cpu")
    edges = tp.edge_set_from_graph(t)
    args = (torch.as_tensor(t.poses), torch.ones(edges.num_edges,
                                                dtype=torch.float64),
            edges, tp.anchor_first_node(t.num_nodes))
    for fn in (tlm.lm_solve, lambda *a: tlm.lm_fixed_iters(*a, 1)):
        with pytest.raises(TypeError, match="SolverConfig"):
            fn(*args, jcfg.SolverConfig(dtype="float64"))


_JAX_IMPORT = re.compile(r"^\s*(from|import)\s+(slam_tpu|jax|jaxlib)(\.|\s|$)",
                         re.M)


def test_port_sources_import_no_slam_tpu():
    files = sorted((REPO / "slam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    for new in ("solver/tridiag.py", "solver/linear.py", "solver/report.py"):
        assert REPO / "slam_tpu_torch" / new in files, new
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
           for f in files for m in _JAX_IMPORT.finditer(f.read_text())]
    assert not bad, bad


def test_source_scan_catches_an_import(tmp_path):
    for line in ("from slam_tpu.config import SolverConfig",
                 "    import slam_tpu", "import jax.numpy as jnp",
                 "from slam_tpu import graph"):
        assert _JAX_IMPORT.search(f"x = 1\n{line}\n"), line
    for line in ("from slam_tpu_torch import config",
                 "import slam_tpu_torch.ops", "# from slam_tpu.x import y"):
        assert not _JAX_IMPORT.search(f"x = 1\n{line}\n"), line


def test_native_library_builds_in_the_port():
    from slam_tpu_torch.io import native

    assert native.available()
    assert native._LIB.parent == REPO / "slam_tpu_torch" / "_build"
    assert os.path.isfile(native._LIB)
