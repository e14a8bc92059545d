"""Static-topology edge tensors.

Port of ``slam_tpu/solver/problem.py``.  An :class:`EdgeSet` holds index
tensors only -- no one-hot incidence operators, no chain head (both were
TPU workarounds) -- plus the precomputed CSR scatter plans of both
endpoints.  Every edge/node gather goes through the ``gather_rows`` kernel,
one launch for both endpoints, and every node sum through the
``scatter_add_rows`` kernel, one launch for all of a linearisation's
sums.  ``active`` is the
per-edge weight that pads, masks and windows without new plans:
``edges._replace(active=mask)`` keeps them.  The loop mask is held as
``loop_f``, in the dtype of ``meas``, the form every robust kernel reads;
``is_loop`` is its boolean view.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.graph import ODOMETRY_EDGE, PoseGraph
from slam_tpu_torch.ops.gather import (
    SegmentPlan,
    gather_rows,
    scatter_add_groups,
    segment_plan,
)
from slam_tpu_torch.runtime import require_type
from slam_tpu_torch.solver.models import model_for_dim

Tensor = torch.Tensor


class EdgeSet(NamedTuple):
    ij: Tensor          # (E, 2) int32 endpoints
    meas: Tensor        # (E, 3) or (E, 7) measured relative pose
    loop_f: Tensor      # (E,) 1.0 closure or bogus (robustified edges), 0.0
    active: Tensor      # (E,) float: 1 live, 0 padded/masked out
    info: Tensor        # (E, 6) or (E, 21) information entries
    plan_a: SegmentPlan  # endpoint a: gather index + scatter plan
    plan_b: SegmentPlan  # endpoint b
    ab: Tensor          # (2E,) int32 endpoints a, then endpoints b

    @property
    def num_edges(self) -> int:
        return self.ij.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.plan_a.n

    @property
    def tangent_dim(self) -> int:
        """Unknowns per node: 3 for SE(2) measurements, 6 for SE(3)."""
        return model_for_dim(self.meas.shape[-1]).tangent_dim

    @property
    def is_loop(self) -> Tensor:
        """(E,) bool: the loop mask."""
        return self.loop_f != 0

    def gather_ab(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """``(x[a], x[b])`` through one ``gather_rows`` launch."""
        both = gather_rows(x, self.ab)
        E = self.num_edges
        return both[:E], both[E:]

    def endpoint_sums(self, *pairs) -> list[Tensor]:
        """``segment_sum(va, a), segment_sum(vb, b)`` of every per-edge
        pair ``(va, vb)``, in order, all in one ``scatter_add_rows``
        launch."""
        return scatter_add_groups([(v, plan) for va, vb in pairs
                                   for v, plan in ((va, self.plan_a),
                                                   (vb, self.plan_b))])

    def node_sums(self, *pairs) -> list[Tensor]:
        """``segment_sum(va, a) + segment_sum(vb, b)`` of every per-edge
        pair ``(va, vb)``, all sums in one ``scatter_add_rows`` launch."""
        sums = self.endpoint_sums(*pairs)
        return [sums[2 * k] + sums[2 * k + 1] for k in range(len(pairs))]


class FreeMask(NamedTuple):
    """Gauge handling: per-node 1.0 = free, 0.0 = held constant."""

    node: Tensor  # (N,) float


def edge_set_from_arrays(ij, meas, is_loop, active, info, num_nodes: int,
                         dtype=torch.float64, device="cpu") -> EdgeSet:
    """Build an :class:`EdgeSet` (and its scatter plans) from host arrays."""
    ij = np.asarray(ij, np.int64)
    if ij.size and (ij.min() < 0 or ij.max() >= num_nodes):
        raise ValueError("edge endpoints out of range")

    def f(a):  # copies, so read-only inputs are safe
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    return EdgeSet(
        ij=torch.as_tensor(ij.astype(np.int32), device=device),
        meas=f(meas),
        loop_f=f(np.asarray(is_loop, bool)),
        active=f(active),
        info=f(info),
        plan_a=segment_plan(ij[:, 0], num_nodes, device=device),
        plan_b=segment_plan(ij[:, 1], num_nodes, device=device),
        ab=torch.as_tensor(ij.T.reshape(-1).astype(np.int32), device=device),
    )


def edge_set_from_graph(graph: PoseGraph, dtype=torch.float64, device="cpu",
                        pad_to: int | None = None) -> EdgeSet:
    """EdgeSet in canonical edge order; ``pad_to`` appends inactive (0, 0)
    edges so the edge count is a bucket size."""
    require_type(graph, PoseGraph, "graph")
    g = graph.canonical_order()
    e = g.num_edges
    pad = 0 if pad_to is None else max(0, pad_to - e)
    # Padded edges are (0, 0) self-loops of weight 0; an SE(3) pad holds
    # the identity quaternion, so its residual stays finite (0 * NaN is
    # NaN).
    meas = np.concatenate([g.edges_meas,
                           np.zeros((pad, g.edges_meas.shape[1]))])
    if pad and g.edges_meas.shape[1] == 7:
        meas[e:, 3] = 1.0
    return edge_set_from_arrays(
        ij=np.concatenate([g.edges_ij, np.zeros((pad, 2), np.int32)]),
        meas=meas,
        is_loop=np.concatenate([g.edge_type != ODOMETRY_EDGE,
                                np.zeros(pad, bool)]),
        active=np.concatenate([np.ones(e), np.zeros(pad)]),
        info=np.concatenate([g.edges_info,
                             np.zeros((pad, g.edges_info.shape[1]))]),
        num_nodes=g.num_nodes, dtype=dtype, device=device,
    )


def anchor_first_node(n: int, dtype=torch.float64, device="cpu") -> FreeMask:
    """Free mask fixing node 0 (the reference's gauge)."""
    m = torch.ones((n,), dtype=dtype, device=device)
    m[0] = 0.0
    return FreeMask(node=m)


def anchor_node(n: int, anchor, dtype=torch.float64, device="cpu") -> FreeMask:
    """Free mask fixing node ``anchor`` (an int or a 0-d tensor)."""
    idx = torch.arange(n, device=device)
    return FreeMask(node=(idx != anchor).to(dtype))


def window_mask(edges: EdgeSet, lo, hi) -> Tensor:
    """Edges whose endpoints both lie in the index window [lo, hi]."""
    a, b = edges.ij[:, 0], edges.ij[:, 1]
    inside = (a >= lo) & (a <= hi) & (b >= lo) & (b <= hi)
    return inside.to(edges.active.dtype)
