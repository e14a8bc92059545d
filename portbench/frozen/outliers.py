"""The benchmark's own bogus-loop injector.

Frozen copy of the SE(2) branch of ``PoseGraph.add_random_outliers`` in
``slam_tpu_torch/graph.py`` at commit 407e87e, itself DCS-ceres
``ReadG2O::add_random_C`` (``g2o_util.h:151-171``) with an explicit seed:
endpoints uniform over the nodes, a self-loop's second endpoint moved to
the next node, the measurement uniform in [0, 1)^3, the information
diag(2, 300, 300).  The bogus edges go last, as the reference stores
them.
"""

from __future__ import annotations

import numpy as np

from portbench.frozen.g2o import BOGUS, Graph


def add_bogus_loops(g: Graph, count: int, seed: int) -> Graph:
    """``g`` with ``count`` bogus loops drawn from ``seed`` appended."""
    if count <= 0:
        return g
    rng = np.random.default_rng(seed)
    n = g.poses.shape[0]
    a = rng.integers(0, n, size=count)
    b = rng.integers(0, n, size=count)
    b = np.where(a == b, (b + 1) % n, b)
    meas = rng.uniform(0.0, 1.0, size=(count, 3))
    info = np.tile(np.array([2.0, 0.0, 0.0, 300.0, 0.0, 300.0]), (count, 1))
    return Graph(
        poses=g.poses.copy(),
        ij=np.concatenate([g.ij, np.stack([a, b], 1).astype(np.int32)]),
        meas=np.concatenate([g.meas, meas]),
        info=np.concatenate([g.info, info]),
        etype=np.concatenate([g.etype, np.full(count, BOGUS, np.int8)]))
