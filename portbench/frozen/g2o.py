"""The benchmark's own reader of 2-D g2o files.

Frozen copy of the SE(2) branch of ``slam_tpu_torch/io/g2o.py``
(``load_g2o`` with the NumPy tokenizer, and ``PoseGraph.canonical_order``
of ``slam_tpu_torch/graph.py``) at commit 407e87e, so that the traffic a
cell runs does not move when the program's reader does.  Reads
``VERTEX_SE2``/``VERTEX2`` and ``EDGE_SE2``/``EDGE2`` records; an edge is
odometry when ``|a - b| < 5`` (DCS-ceres ``g2o_util.h:68``), else a loop
closure; edges come back odometry first, then closures, each in file
order.
"""

from __future__ import annotations

import io
from typing import NamedTuple

import numpy as np

ODOMETRY, CLOSURE, BOGUS = 0, 1, 2
ODOMETRY_INDEX_GAP = 5
_VERTEX_TAGS = ("VERTEX_SE2", "VERTEX2")
_EDGE_TAGS = ("EDGE_SE2", "EDGE2")


class Graph(NamedTuple):
    """Structure-of-arrays pose graph: ``poses`` (N, 3) float64, ``ij``
    (E, 2) int32, ``meas`` (E, 3), ``info`` (E, 6) upper-triangle
    information entries, ``etype`` (E,) int8 (0 odometry, 1 closure,
    2 bogus)."""

    poses: np.ndarray
    ij: np.ndarray
    meas: np.ndarray
    info: np.ndarray
    etype: np.ndarray


def _records(text: str, tag: str, ncols: int) -> np.ndarray:
    rows = [line[len(tag):] for line in text.splitlines()
            if line.startswith(tag + " ")]
    if not rows:
        return np.empty((0, ncols))
    return np.loadtxt(io.StringIO("\n".join(rows)), dtype=np.float64,
                      ndmin=2)[:, :ncols]


def canonical(g: Graph) -> Graph:
    """Edges sorted odometry, closure, bogus; stable within each."""
    order = np.argsort(g.etype, kind="stable")
    return Graph(g.poses.copy(), g.ij[order], g.meas[order], g.info[order],
                 g.etype[order])


def read(path: str) -> Graph:
    """Parse a 2-D g2o file."""
    with open(path) as f:
        text = f.read()
    verts = np.concatenate([_records(text, t, 4) for t in _VERTEX_TAGS])
    edges = np.concatenate([_records(text, t, 11) for t in _EDGE_TAGS])
    if verts.shape[0] == 0:
        raise ValueError(f"no 2-D vertices in {path}")
    verts = verts[np.argsort(verts[:, 0], kind="stable")]
    ij = edges[:, 0:2].astype(np.int32)
    etype = np.where(np.abs(ij[:, 0] - ij[:, 1]) < ODOMETRY_INDEX_GAP,
                     ODOMETRY, CLOSURE).astype(np.int8)
    return canonical(Graph(verts[:, 1:4].copy(), ij, edges[:, 2:5].copy(),
                           edges[:, 5:11].copy(), etype))
