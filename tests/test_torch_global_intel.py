"""The main path's graph, INTEL+50 seed 42, through both packages' global
solve at a few iterations with two consensus chains (float64, CPU): poses
agree to 1e-6 and the rescue takes the same decisions."""

from slam_tpu.config import RunConfig, SolverConfig
from slam_tpu.io import g2o
from test_torch_global_solve import compare_runs


def test_intel50_global_solve_matches():
    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    dirty = graph.add_random_outliers(50, seed=42)
    cfg = RunConfig(dataset="INTEL", method=1, num_outliers=50, seed=42,
                    solver=SolverConfig(dtype="float64",
                                        max_iterations=5,
                                        dcs_consensus_chains=2))
    records = compare_runs(dirty, cfg)
    retry = [f for tag, f in records if tag == "retry"]
    assert len(retry) == 1 and retry[0]["best"] == "consensus0"
