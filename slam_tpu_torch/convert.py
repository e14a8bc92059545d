"""State carried across from the JAX package.

The system has no weights; its state is the graph, the poses and the
partition.  These functions read the JAX package's objects as NumPy arrays
(``np.asarray`` on each field -- no JAX import here) and build the port's,
so tests can feed both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.solver.problem import EdgeSet, FreeMask, \
    edge_set_from_arrays
from slam_tpu_torch.solver.schur import SchurPartition, SlotMaps, \
    partition_from_slots


def edge_set_from_jax(edges, num_nodes: int, dtype=torch.float64,
                      device="cpu") -> EdgeSet:
    """The port's EdgeSet from a JAX ``EdgeSet`` (one-hot incidence
    operators, if any, are dropped; the scatter plans are rebuilt)."""
    return edge_set_from_arrays(
        ij=np.asarray(edges.ij), meas=np.asarray(edges.meas),
        is_loop=np.asarray(edges.is_loop), active=np.asarray(edges.active),
        info=np.asarray(edges.info), num_nodes=num_nodes, dtype=dtype,
        device=device)


def free_mask_from_jax(free, dtype=torch.float64, device="cpu") -> FreeMask:
    return FreeMask(node=torch.tensor(np.asarray(free.node), dtype=dtype,
                                         device=device))


def _slots(onehot) -> np.ndarray:
    """Row-wise one-hot -> column index, -1 for all-zero (padding) rows."""
    m = np.asarray(onehot)
    return np.where(m.sum(-1) > 0, m.argmax(-1), -1).astype(np.int64)


def slots_from_jax(part) -> SlotMaps:
    """Slot maps of a JAX ``SchurPartition`` (same padding conventions)."""
    return SlotMaps(
        int_ids=_slots(part.int_sel),
        sep_ids=_slots(part.sep_sel),
        edge_ids=_slots(part.edge_sel),
        int_a=_slots(part.int_a),
        int_b=_slots(part.int_b),
        sep_a=_slots(part.sep_a),
        sep_b=_slots(part.sep_b),
        loc_ids=_slots(part.loc_sel),
        sepedge_ids=_slots(part.sepedge_sel),
        se_sep_a=_slots(part.se_sep_a),
        se_sep_b=_slots(part.se_sep_b),
        num_nodes=int(np.asarray(part.int_sel).shape[2]),
        num_edges=int(np.asarray(part.edge_sel).shape[2]),
    )


def partition_from_jax(part, dtype=torch.float64,
                       device="cpu") -> SchurPartition:
    """The port's partition (slot maps + scatter plans) from the JAX one."""
    return partition_from_slots(slots_from_jax(part), dtype=dtype,
                                device=device)


def lm_result_to_numpy(res) -> dict:
    """An LMResult of either package as a dict of NumPy values."""
    out = {}
    for name in res._fields:
        v = getattr(res, name)
        if v is None:
            out[name] = None
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out
