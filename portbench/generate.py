"""The one generator of the benchmark's inputs.

A cell's inputs are ``lanes`` problems of its configuration's graph, each
with its own bogus loops: lane ``b`` of a run with ``--seed s`` draws its
``bogus_loops`` from the seed ``s * lanes + b`` (so ``--seed 0`` gives
``bench.py``'s seeds 0-7), with the frozen reader and injector.  The
dataset is the repository's file, held to the SHA-256 its configuration
records.  Every
seed gives every lane the same number of nodes and edges; only where the
bogus loops land differs.  The initial poses are the dataset's.
"""

from __future__ import annotations

import hashlib

from portbench.cell import ROOT
from portbench.frozen import g2o, outliers


def lane_seeds(seed: int, lanes: int) -> list[int]:
    return [seed * lanes + b for b in range(lanes)]


def graphs(config: dict, traffic: dict, seed: int) -> list[g2o.Graph]:
    """The ``traffic["lanes"]`` graphs of a run, edges in canonical order."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, got {seed}")
    path = ROOT / config["dataset"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != config["dataset_sha256"]:
        raise ValueError(f"{config['dataset']} is not the file the "
                         f"configuration was measured on (sha256 {digest}, "
                         f"expected {config['dataset_sha256']})")
    base = g2o.read(str(path))
    if (base.poses.shape[0], base.ij.shape[0]) != (config["nodes"],
                                                   config["edges"]):
        raise ValueError(f"{config['dataset']} holds {base.poses.shape[0]} "
                         f"nodes and {base.ij.shape[0]} edges, the "
                         f"configuration {config['nodes']} and "
                         f"{config['edges']}")
    return [g2o.canonical(outliers.add_bogus_loops(
                base, config["bogus_loops"], s))
            for s in lane_seeds(seed, traffic["lanes"])]
