"""Partitioned Schur-complement direct solver.

Port of ``slam_tpu/solver/schur.py``.  The graph is cut into P blocks; each
block's interior is eliminated with a batched dense Cholesky and the
coupled separator system is reduced and solved:

    H = [[A, F], [F^T, C]],  A = blkdiag(A_1..A_P)
    S = C - sum_k F_k^T A_k^{-1} F_k,   x_k = A_k^{-1} (b_k - F_k x_s)

The host builder keeps the JAX package's partition choice (cost model,
fitted weights and 128-tile padding verbatim, so both packages pick the
same partition) but emits integer slot maps (:class:`SlotMaps`) instead of
one-hot selectors.  From those, :func:`partition_from_slots` precomputes
CSR scatter plans, and the device solve assembles A, F, b, C and the
separator reductions by scattering per-edge D x D block products through
``scatter_add_rows`` (the JAX package expands one-hot matmuls instead):
one launch for the five assembly plans, whose block-grid plans place
their blocks straight into the row-major matrices, one for the separator
reductions and one for the write-back.
All matrices use node-major unknowns (slot * D + coordinate), where the
JAX package's are coordinate-major, so the two packages factor permuted
matrices and only the solution is comparable between them.

``schur_solve(blocked=True)`` (``SolverConfig.schur_blocked``) factors the
interiors and the separator with the panel-blocked Cholesky of
``blocked_chol.py``, whose diagonal panels can go through the
``micro_chol_inv`` kernel (``pallas_micro``); the default is the native
``cholesky_ex``/``solve_triangular`` branch.

A partition built with ``seeds=B`` (``solver/batch.py``) holds B seeds'
partitions of one padded shape, the counterpart of the JAX package's
``vmap`` over stacked partitions: its interiors are B*P blocks, and its
separator is B systems of ``D*ns``, one per seed (never one system of
``B*D*ns``), a stack that the native path factors with
``ops.stack_chol.stack_cholesky`` (on the card one blocked Cholesky of
every seed's separator in lockstep, each seed's factor its own alone to
the bit; one problem's separator is a stack of one) and solves with
``linear.cho_solve_stack``; every other launch of a solve serves every
seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops.gather import SegmentPlan, gather_rows, \
    scatter_add_groups, scatter_add_rows, segment_plan
from slam_tpu_torch.ops.stack_chol import stack_cholesky
from slam_tpu_torch.solver import blocked_chol as bc
from slam_tpu_torch.solver.linear import Update, _DIAG_MAX, _DIAG_MIN, \
    cho_solve_stack, nan_unless_factored
from slam_tpu_torch.solver.linearize import BlockSystem
from slam_tpu_torch.solver.problem import EdgeSet
from slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# Interior-elimination strategy threshold: explicit L-inverse up to this
# interior dimension D*ni, one triangular pass above.  The switch point
# was measured on the TPU; module-level so tests can force either branch.
_INV_MAX_DIM = 1024


# ---------------------------------------------------------------------------
# Host builder: partition choice (kept verbatim from the JAX package)
# ---------------------------------------------------------------------------

def optimize_cut_positions(
    ij: np.ndarray, n: int, num_blocks: int, slack: float = 0.5
) -> np.ndarray:
    """Contiguous-block cut positions minimising the number of edges that
    span a cut (dynamic program); block sizes within
    ``n/num_blocks * (1 +- slack)``.  Returns the block id of every node."""
    ij = np.asarray(ij)
    a = np.minimum(ij[:, 0], ij[:, 1])
    b = np.maximum(ij[:, 0], ij[:, 1])
    diff = np.zeros(n + 1, np.int64)
    np.add.at(diff, a + 1, 1)
    np.add.at(diff, b + 1, -1)
    span = np.cumsum(diff)[:n]

    target = n / num_blocks
    lo = max(1, int(np.floor(target * (1 - slack))))
    hi = max(lo, int(np.ceil(target * (1 + slack))))

    INF = np.iinfo(np.int64).max // 4
    f = np.full((num_blocks + 1, n + 1), INF, np.int64)
    prev = np.zeros((num_blocks + 1, n + 1), np.int32)
    f[0, 0] = 0
    for k in range(1, num_blocks + 1):
        for c in range(k * lo, min(k * hi, n) + 1):
            if k == num_blocks and c != n:
                continue
            pmin, pmax = max((k - 1) * lo, c - hi), min((k - 1) * hi, c - lo)
            if pmax < pmin:
                continue
            seg = f[k - 1, pmin : pmax + 1]
            j = int(np.argmin(seg))
            best = seg[j]
            if best >= INF:
                continue
            cost = best + (span[c] if c < n else 0)
            if cost < f[k, c]:
                f[k, c] = cost
                prev[k, c] = pmin + j
    if f[num_blocks, n] >= INF:
        raise ValueError("no feasible cut placement")
    cuts = []
    c = n
    for k in range(num_blocks, 0, -1):
        cuts.append(c)
        c = int(prev[k, c])
    cuts = cuts[::-1]
    node_block = np.zeros(n, np.int64)
    start = 0
    for k, end in enumerate(cuts):
        node_block[start:end] = k
        start = end
    return node_block


def _assign_blocks(
    ij: np.ndarray, n: int, num_blocks: int, optimize_cuts: bool,
    node_block: np.ndarray | None = None,
):
    """``(sep_ids, interior_ids, block_edges, sep_edges)`` of a partition
    (contiguous index ranges, optimised cuts, or any ``node_block``)."""
    ij = np.asarray(ij)
    E = ij.shape[0]
    if node_block is not None:
        node_block = np.asarray(node_block, np.int64)
        if node_block.shape != (n,) or (n and (
                node_block.min() < 0 or node_block.max() >= num_blocks)):
            raise ValueError(
                f"node_block must be ({n},) with ids in [0, {num_blocks})")
    elif optimize_cuts:
        node_block = optimize_cut_positions(ij, n, num_blocks)
    else:
        block_size = -(-n // num_blocks)
        node_block = np.minimum(np.arange(n) // block_size, num_blocks - 1)

    ba = node_block[ij[:, 0]]
    bb = node_block[ij[:, 1]]
    cross = ba != bb
    sep = np.zeros(n, bool)
    sep[ij[cross, 0]] = True
    sep[ij[cross, 1]] = True
    sep[0] = True  # gauge anchor lives in the separator system

    sep_ids = np.where(sep)[0]
    interior_ids = [
        np.where((node_block == k) & ~sep)[0] for k in range(num_blocks)
    ]
    owner = np.full(E, -1, np.int64)
    a_int = ~sep[ij[:, 0]]
    b_int = ~sep[ij[:, 1]]
    owner[a_int] = ba[a_int]
    owner[b_int & (owner < 0)] = bb[b_int & (owner < 0)]
    block_edges = [np.where(owner == k)[0] for k in range(num_blocks)]
    # Self-loops (bucket padding points pads at (0, 0)) touch only C.
    sep_edges = np.where(
        (sep[ij[:, 0]] | sep[ij[:, 1]]) & (ij[:, 0] != ij[:, 1])
    )[0]
    return sep_ids, interior_ids, block_edges, sep_edges


def _local_sep_ids(ij, n, sep_ids, block_edges) -> list:
    """Per-block sorted GLOBAL separator slots adjacent to its edges."""
    sep_slot = np.full(n, -1, np.int64)
    sep_slot[np.asarray(sep_ids, np.int64)] = np.arange(len(sep_ids))
    out = []
    for ids in block_edges:
        if len(ids):
            eps = np.asarray(ij)[np.asarray(ids, np.int64)].reshape(-1)
            slots = sep_slot[eps]
            out.append(sorted(set(int(s) for s in slots if s >= 0)))
        else:
            out.append([])
    return out


def partition_stats(
    ij: np.ndarray, n: int, num_blocks: int, optimize_cuts: bool = False,
    node_block: np.ndarray | None = None,
) -> tuple[int, int, int, int, int]:
    """``(ni_max, ns, ek_max, es_max, nsk_max)`` of a partition."""
    sep_ids, interior_ids, block_edges, sep_edges = _assign_blocks(
        ij, n, num_blocks, optimize_cuts, node_block
    )
    ni_max = max(1, max(len(x) for x in interior_ids))
    ek_max = max(1, max(len(x) for x in block_edges))
    loc = _local_sep_ids(np.asarray(ij), n, sep_ids, block_edges)
    nsk_max = max(1, max(len(x) for x in loc))
    return ni_max, len(sep_ids), ek_max, max(1, len(sep_edges)), nsk_max


def _tile(x: int | float, t: int = 128) -> int:
    """Round ``x`` up to a multiple of 128 (the cost model's tile)."""
    x = int(x)
    return -(-x // t) * t


def _partition_cost(
    stats: tuple[int, int, int, int, int], P: int, D: int, R: int
) -> float:
    """Tile-padded cost model of one solve (terms and weights as fitted in
    the JAX package, ``slam_tpu/solver/schur.py``; refitting them to this
    card is ROADMAP work)."""
    ni, ns, ek, es, nsk = stats
    dni, dns, ekR = D * ni, D * ns, ek * R
    dnsk = D * nsk
    p = _tile
    return (
        P * p(dni) ** 3 / 3
        + 2 * P * p(dni) * p(dni) * p(dnsk)
        + P * p(dni) * p(dni) * p(ekR)
        + P * p(dni) * p(dnsk) * p(ekR)
        + P * p(dnsk) * p(dnsk) * p(dni)
        + 0.5 * P * p(dnsk) * p(dns) * (p(dnsk) + p(dns))
        + 0.5 * p(dns) ** 3 / 3
        + 0.3 * p(es * R) * p(dns) * p(dns)
    )


def choose_partition(
    ij: np.ndarray,
    n: int,
    tangent_dim: int = 3,
    residual_dim: int | None = None,
    candidates: tuple[int, ...] = (2, 4, 6, 8, 12, 16, 24, 32),
    scheme: str = "auto",
    cap: bool = True,
) -> tuple[int, np.ndarray | None]:
    """Pick ``(num_blocks, node_block)`` across the index and spectral
    schemes under the shared cost model (``node_block`` is None for the
    contiguous index scheme)."""
    ij = np.asarray(ij)
    D = tangent_dim
    R = residual_dim if residual_dim is not None else tangent_dim
    best: tuple[float, int, np.ndarray | None] | None = None
    if scheme in ("index", "auto"):
        P = choose_num_blocks(ij, n, tangent_dim, residual_dim,
                              candidates, cap)
        f = _partition_cost(partition_stats(ij, n, P), P, D, R)
        best = (f, P, None)
    if scheme in ("graph", "auto") and n // 2 >= 8:
        from slam_tpu_torch.solver.partition import partition_tree

        max_parts = max(p for p in candidates if n // p >= 8)
        levels = partition_tree(ij, n, max_parts=max_parts)
        for P, nb in levels.items():
            stats = partition_stats(ij, n, P, node_block=nb)
            if cap and D >= 6 and stats[1] > n // 8:
                continue
            f = _partition_cost(stats, P, D, R)
            if best is None or f < best[0]:
                best = (f, P, nb)
    if best is None:
        P = choose_num_blocks(ij, n, tangent_dim, residual_dim,
                              candidates, cap)
        return P, None
    return best[1], best[2]


def choose_num_blocks(
    ij: np.ndarray,
    n: int,
    tangent_dim: int = 3,
    residual_dim: int | None = None,
    candidates: tuple[int, ...] = (2, 4, 6, 8, 12, 16, 24, 32),
    cap: bool = True,
) -> int:
    """Block count minimising the cost model over contiguous partitions
    (SE(3) separators above n/8 rejected, as in the JAX package)."""
    ij = np.asarray(ij)
    D = tangent_dim
    R = residual_dim if residual_dim is not None else tangent_dim
    best_p, best_f = None, None
    for P in candidates:
        if P < 2 or n // P < 8:
            continue
        stats = partition_stats(ij, n, P)
        if cap and D >= 6 and stats[1] > n // 8:
            continue
        f = _partition_cost(stats, P, D, R)
        if best_f is None or f < best_f:
            best_p, best_f = P, f
    if best_p is None:
        return choose_num_blocks(ij, n, tangent_dim, residual_dim,
                                 candidates, cap=False)
    return best_p


# ---------------------------------------------------------------------------
# Host builder: slot maps and scatter plans
# ---------------------------------------------------------------------------

class SlotMaps(NamedTuple):
    """Integer form of a partition; ``-1`` marks padding everywhere.

    * ``int_ids`` (P, ni): node of each interior slot
    * ``sep_ids`` (ns,): node of each separator slot
    * ``edge_ids`` (P, ek): edges owned by block k (an interior endpoint)
    * ``int_a``/``int_b`` (P, ek): interior slot of each endpoint
    * ``sep_a``/``sep_b`` (P, ek): LOCAL separator slot of each endpoint
    * ``loc_ids`` (P, nsk): global separator slot of each local slot
    * ``sepedge_ids`` (es,): edges with a separator endpoint (no
      self-loops) -- the only rows of the separator system C
    * ``se_sep_a``/``se_sep_b`` (es,): their global separator slots
    """

    int_ids: np.ndarray
    sep_ids: np.ndarray
    edge_ids: np.ndarray
    int_a: np.ndarray
    int_b: np.ndarray
    sep_a: np.ndarray
    sep_b: np.ndarray
    loc_ids: np.ndarray
    sepedge_ids: np.ndarray
    se_sep_a: np.ndarray
    se_sep_b: np.ndarray
    num_nodes: int
    num_edges: int


def build_slots(
    ij: np.ndarray,
    n: int,
    num_blocks: int,
    pad_shapes: tuple[int, ...] | None = None,
    optimize_cuts: bool = False,
    node_block: np.ndarray | None = None,
) -> SlotMaps:
    """Slot maps of a partition; ``pad_shapes=(ni, ns, ek, es, nsk)`` pads
    them to shared maxima (3-/4-tuples accepted, as in the JAX package)."""
    ij = np.asarray(ij, np.int64)
    E = ij.shape[0]
    sep_ids, interior_ids, block_edges, sep_edges = _assign_blocks(
        ij, n, num_blocks, optimize_cuts, node_block
    )
    ns = len(sep_ids)
    ni_max = max(1, max(len(x) for x in interior_ids))
    ek_max = max(1, max(len(x) for x in block_edges))
    es_max = max(1, len(sep_edges))
    loc_list = _local_sep_ids(ij, n, sep_ids, block_edges)
    nsk_max = max(1, max(len(x) for x in loc_list))
    ns_pad = ns
    if pad_shapes is not None:
        tni, tns, tek = pad_shapes[:3]
        tes = pad_shapes[3] if len(pad_shapes) > 3 else es_max
        tnsk = pad_shapes[4] if len(pad_shapes) > 4 else nsk_max
        if not (tni >= ni_max and tns >= ns and tek >= ek_max
                and tes >= es_max and tnsk >= nsk_max):
            raise ValueError(
                "pad_shapes smaller than this partition's natural sizes")
        ni_max, ns_pad, ek_max, es_max, nsk_max = tni, tns, tek, tes, tnsk

    P = num_blocks

    def full(shape):
        return np.full(shape, -1, np.int64)

    sep_slot = full(n)
    sep_slot[sep_ids] = np.arange(ns)
    int_slot = full(n)
    node_block_of = full(n)
    int_ids = full((P, ni_max))
    for k, ids in enumerate(interior_ids):
        int_ids[k, : len(ids)] = ids
        int_slot[ids] = np.arange(len(ids))
        node_block_of[ids] = k
    sep_ids_p = full(ns_pad)
    sep_ids_p[:ns] = sep_ids

    loc_ids = full((P, nsk_max))
    loc_slot = full((P, max(ns, 1)))
    for k, gids in enumerate(loc_list):
        loc_ids[k, : len(gids)] = gids
        loc_slot[k, gids] = np.arange(len(gids))

    edge_ids = full((P, ek_max))
    maps = {name: full((P, ek_max))
            for name in ("int_a", "int_b", "sep_a", "sep_b")}
    for k, ids in enumerate(block_edges):
        m = len(ids)
        edge_ids[k, :m] = ids
        for col, iname, sname in ((0, "int_a", "sep_a"),
                                  (1, "int_b", "sep_b")):
            ep = ij[ids, col]
            ss = sep_slot[ep]
            is_sep = ss >= 0
            srow = maps[sname][k, :m]
            srow[is_sep] = loc_slot[k, ss[is_sep]]
            own = ~is_sep & (node_block_of[ep] == k)
            irow = maps[iname][k, :m]
            irow[own] = int_slot[ep[own]]

    sepedge_ids = full(es_max)
    sepedge_ids[: len(sep_edges)] = sep_edges
    se_sep_a = full(es_max)
    se_sep_b = full(es_max)
    se_sep_a[: len(sep_edges)] = sep_slot[ij[sep_edges, 0]]
    se_sep_b[: len(sep_edges)] = sep_slot[ij[sep_edges, 1]]
    return SlotMaps(
        int_ids=int_ids, sep_ids=sep_ids_p, edge_ids=edge_ids,
        loc_ids=loc_ids, sepedge_ids=sepedge_ids, se_sep_a=se_sep_a,
        se_sep_b=se_sep_b, num_nodes=int(n), num_edges=int(E), **maps,
    )


class SchurPartition(NamedTuple):
    """Device form of a partition: slot gathers, masks and the CSR plans
    that assemble the block systems.  Per-edge sources are the block rows
    ``[Haa, Hbb, Hab, Hba]`` (4E) and the gradients ``[ga, gb]`` (2E);
    the block-grid plans give row-major ``(.., rows*D, cols*D)`` matrices."""

    slots: SlotMaps
    node_gather: Tensor  # (P*ni + ns + P*nsk,) int32 node of each interior,
    #                      separator and local separator slot (pad 0)
    int_mask: Tensor     # (P, ni) 1 for real interior slots
    sep_live: Tensor     # (ns,) 1 for real separator slots
    loc_gather: Tensor   # (P*nsk,) int32 global sep slot of each local slot
    loc_mask: Tensor     # (P, nsk)
    loc_live: Tensor     # (P, nsk) loc_mask * sep_live[loc_gather]
    plan_A: SegmentPlan    # 4E block rows -> (P, ni, ni) block grid
    plan_F: SegmentPlan    # 4E block rows -> (P, ni, nsk) block grid
    plan_b: SegmentPlan    # 2E gradient rows -> (P, ni)
    plan_C: SegmentPlan    # 4E block rows -> (ns, ns) block grid
    plan_bs: SegmentPlan   # 2E gradient rows -> (ns,)
    plan_S: SegmentPlan    # (P, nsk, nsk) local blocks -> (ns, ns) grid
    plan_rs: SegmentPlan   # (P, nsk) local rows -> (ns,)
    plan_out: SegmentPlan  # [separator slots, interior slots] -> nodes
    seeds: int | None = None  # B of a seed batch, None for one problem

    @property
    def sep_lead(self) -> tuple[int, ...]:
        """Leading shape of the separator system: () or (B,)."""
        return () if self.seeds is None else (self.seeds,)

    @property
    def num_blocks(self) -> int:
        """Interior blocks: P, or B*P in a seed batch."""
        return self.slots.int_ids.shape[0]

    @property
    def ni_max(self) -> int:
        return self.slots.int_ids.shape[1]

    @property
    def ns(self) -> int:
        """Separator slots of one problem (of each seed in a batch)."""
        return self.slots.sep_ids.shape[0] // (self.seeds or 1)

    @property
    def ek_max(self) -> int:
        return self.slots.edge_ids.shape[1]

    @property
    def es_max(self) -> int:
        return self.slots.sepedge_ids.shape[0]

    @property
    def nsk_max(self) -> int:
        return self.slots.loc_ids.shape[1]


def _block_entries(e, sa, sb, E):
    """The D x D blocks an edge adds between its endpoint slots ``sa``/``sb``
    (-1 = not in this system): ``(row, col, 4E source row, entry)``, where
    ``entry`` indexes the inputs."""
    rows, cols, src, sel = [], [], [], []
    for r, c, kind in ((sa, sa, 0), (sb, sb, 1), (sa, sb, 2), (sb, sa, 3)):
        ok = np.nonzero((e >= 0) & (r >= 0) & (c >= 0))[0]
        rows.append(r[ok])
        cols.append(c[ok])
        src.append(kind * E + e[ok])
        sel.append(ok)
    return tuple(np.concatenate(x) for x in (rows, cols, src, sel))


def _grad_entries(e, sa, sb, E):
    """Gradient rows of the same: ``(slot, 2E source row, entry)``."""
    rows, src, sel = [], [], []
    for s, kind in ((sa, 0), (sb, 1)):
        ok = np.nonzero((e >= 0) & (s >= 0))[0]
        rows.append(s[ok])
        src.append(kind * E + e[ok])
        sel.append(ok)
    return tuple(np.concatenate(x) for x in (rows, src, sel))


def partition_from_slots(slots: SlotMaps, dtype=torch.float64,
                         device="cpu", seeds: int | None = None
                         ) -> SchurPartition:
    """Precompute the device gathers and scatter plans of a partition;
    ``seeds=B`` reads ``slots`` as B seeds' stacked slot maps, whose
    separator slots ``b*ns ..`` are seed b's (``batch.stack_slots``)."""
    s = slots
    P, ni = s.int_ids.shape
    nsk = s.loc_ids.shape[1]
    lead = () if seeds is None else (seeds,)
    nst = s.sep_ids.shape[0]    # separator slots in all
    ns = nst // (seeds or 1)    # of each seed
    N, E = s.num_nodes, s.num_edges
    blk = np.repeat(np.arange(P), s.edge_ids.shape[1])

    def plan(idx, n, src, grid=None):
        return segment_plan(idx, n, src=src, device=device, grid=grid)

    # A: interior x interior blocks of every owned edge.
    e = s.edge_ids.reshape(-1)
    ia, ib = s.int_a.reshape(-1), s.int_b.reshape(-1)
    r, c, src, sel = _block_entries(e, ia, ib, E)
    plan_A = plan((blk[sel] * ni + r) * ni + c, P * ni * ni, src,
                  ((P,), ni, ni))
    # F: interior rows x local separator columns (Hab at (ia, sb), Hba at
    # (ib, sa); an endpoint is interior or separator, never both).
    sa, sb = s.sep_a.reshape(-1), s.sep_b.reshape(-1)
    ok_ab = (e >= 0) & (ia >= 0) & (sb >= 0)
    ok_ba = (e >= 0) & (ib >= 0) & (sa >= 0)
    f_idx = np.concatenate([(blk[ok_ab] * ni + ia[ok_ab]) * nsk + sb[ok_ab],
                            (blk[ok_ba] * ni + ib[ok_ba]) * nsk + sa[ok_ba]])
    f_src = np.concatenate([2 * E + e[ok_ab], 3 * E + e[ok_ba]])
    plan_F = plan(f_idx, P * ni * nsk, f_src, ((P,), ni, nsk))
    rows, src, sel = _grad_entries(e, ia, ib, E)
    plan_b = plan(blk[sel] * ni + rows, P * ni, src)
    # C and its rhs: every separator edge, global separator slots.  In a
    # seed batch both endpoints are seed b's slots b*ns + r', so the block
    # (r, c) lands at (b, r', c') of the (B, ns, ns) grid.
    se = s.sepedge_ids
    r, c, src, _ = _block_entries(se, s.se_sep_a, s.se_sep_b, E)
    plan_C = plan(r * ns + c % ns, nst * ns, src,
                  (lead, ns, ns))
    rows, src, _ = _grad_entries(se, s.se_sep_a, s.se_sep_b, E)
    plan_bs = plan(rows, nst, src)
    # Local -> global separator expansion of the per-block reductions.
    loc = s.loc_ids
    m1 = np.broadcast_to(loc[:, :, None], (P, nsk, nsk))
    m2 = np.broadcast_to(loc[:, None, :], (P, nsk, nsk))
    ok = (m1 >= 0) & (m2 >= 0)
    plan_S = plan((m1 * ns + m2 % ns)[ok], nst * ns,
                  np.arange(P * nsk * nsk).reshape(P, nsk, nsk)[ok],
                  (lead, ns, ns))
    okl = loc >= 0
    plan_rs = plan(loc[okl], nst, np.arange(P * nsk).reshape(P, nsk)[okl])
    # Solution back to nodes: rows [x_sep (ns), x_int (P*ni)].
    out_nodes = np.concatenate([s.sep_ids, s.int_ids.reshape(-1)])
    oko = out_nodes >= 0
    plan_out = plan(out_nodes[oko], N, np.arange(out_nodes.shape[0])[oko])

    def idx32(a):
        return torch.as_tensor(np.maximum(a, 0).reshape(-1).astype(np.int32),
                               device=device)

    def mask(a):
        return torch.as_tensor((a >= 0).astype(np.float64), dtype=dtype,
                               device=device)

    # The local separator slots' nodes, for the scales the assembly
    # gathers with the interior and separator values in one launch.
    loc_node = np.maximum(s.sep_ids, 0)[np.maximum(loc, 0)]
    loc_live = (loc >= 0) & (s.sep_ids[np.maximum(loc, 0)] >= 0)
    return SchurPartition(
        slots=slots,
        node_gather=idx32(np.concatenate([s.int_ids.reshape(-1), s.sep_ids,
                                          loc_node.reshape(-1)])),
        int_mask=mask(s.int_ids), sep_live=mask(s.sep_ids),
        loc_gather=idx32(s.loc_ids), loc_mask=mask(s.loc_ids),
        loc_live=torch.as_tensor(loc_live.astype(np.float64), dtype=dtype,
                                 device=device),
        plan_A=plan_A, plan_F=plan_F, plan_b=plan_b, plan_C=plan_C,
        plan_bs=plan_bs, plan_S=plan_S, plan_rs=plan_rs, plan_out=plan_out,
        seeds=seeds,
    )


def build_partition(
    ij: np.ndarray,
    n: int,
    num_blocks: int,
    dtype=torch.float64,
    device="cpu",
    pad_shapes: tuple[int, ...] | None = None,
    optimize_cuts: bool = False,
    node_block: np.ndarray | None = None,
) -> SchurPartition:
    """Partition (index ranges, optimised cuts or ``node_block``) with a
    cross-edge separator, ready for :func:`schur_solve`."""
    slots = build_slots(ij, n, num_blocks, pad_shapes=pad_shapes,
                        optimize_cuts=optimize_cuts, node_block=node_block)
    return partition_from_slots(slots, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Device solve
# ---------------------------------------------------------------------------

def _blocks(mat: Tensor, lead: tuple[int, ...], rows: int, cols: int,
            D: int) -> Tensor:
    """(..., rows*D, cols*D) matrix -> its D x D blocks, row-major, as
    (prod(lead)*rows*cols, D*D) rows."""
    g = mat.reshape(*lead, rows, D, cols, D)
    nd = len(lead)
    g = g.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return g.reshape(-1, D * D)


class SchurSystem(NamedTuple):
    """The damped system of a partition in the equilibrated space (in a
    seed batch P is B*P, and the separator fields lead with B)."""

    A: Tensor      # (P, D*ni, D*ni) interior blocks
    F: Tensor      # (P, D*ni, D*nsk) interior x local separator coupling
    b: Tensor      # (P, D*ni) interior right-hand sides
    C: Tensor      # ([B,] D*ns, D*ns) separator block
    b_sep: Tensor  # ([B,] D*ns)
    s_int: Tensor  # (P, D*ni) equilibration scale of the interior slots
    s_sep: Tensor  # ([B,] D*ns)


def assemble(system: BlockSystem, part: SchurPartition,
             lam: Tensor) -> SchurSystem:
    """Scatter the per-edge blocks into the damped, Jacobi-equilibrated
    ``D^-1/2 H D^-1/2`` system of the partition (pose unknowns only).
    ``lam`` is 0-d, or ``(N, 1)``: each node's (a seed batch's damping)."""
    E, R, D = system.Ja.shape
    dtype = system.Ja.dtype
    P, ni, ns, nsk = part.num_blocks, part.ni_max, part.ns, part.nsk_max
    sl, nst = part.sep_lead, part.slots.sep_ids.shape[0]

    # Node damping, equilibration scale and gauge pins, gathered to slots.
    dnode = torch.diagonal(system.Hdiag, dim1=-2, dim2=-1)     # (N, D)
    clipd = torch.clamp(dnode, _DIAG_MIN, _DIAG_MAX)
    zero_diag = dnode == 0.0
    pin = zero_diag.to(dtype)
    scale = torch.where(zero_diag, torch.ones_like(dnode),
                        1.0 / torch.sqrt(clipd))
    dampv = lam * clipd * scale * scale
    node_vals = torch.cat([scale, dampv, pin], dim=1)         # (N, 3D)
    vals = gather_rows(node_vals, part.node_gather)
    vi = (vals[:P * ni].reshape(P, ni, 3, D)
          * part.int_mask[:, :, None, None])
    s_int = vi[:, :, 0].reshape(P, ni * D)
    diag_int = (vi[:, :, 1] + torch.maximum(
        vi[:, :, 2], 1.0 - part.int_mask[:, :, None])).reshape(P, ni * D)
    vs = (vals[P * ni:P * ni + nst].reshape(nst, 3, D)
          * part.sep_live[:, None, None])
    s_sep = vs[:, 0].reshape(*sl, ns * D)
    diag_sep = (vs[:, 1] + torch.maximum(
        vs[:, 2], 1.0 - part.sep_live[:, None])).reshape(*sl, ns * D)
    # The masks are 0/1 and the scales positive, so this is s_sep's value
    # at each local slot to the bit.
    s_loc = (vals[P * ni + nst:].reshape(P, nsk, 3, D)[:, :, 0]
             * part.loc_live[:, :, None]).reshape(P, nsk * D)

    # Per-edge block products: the rows every assembly plan reads.
    wJa = system.w[:, None, None] * system.Ja
    wJb = system.w[:, None, None] * system.Jb
    Hab = torch.einsum("eki,ekj->eij", wJa, system.Jb)
    rows4 = torch.cat([
        torch.einsum("eki,ekj->eij", wJa, system.Ja),
        torch.einsum("eki,ekj->eij", wJb, system.Jb),
        Hab, Hab.transpose(-1, -2)]).reshape(4 * E, D * D)
    rows2 = torch.cat([torch.einsum("eki,ek->ei", wJa, system.r),
                       torch.einsum("eki,ek->ei", wJb, system.r)])

    A, F, b, C, b_sep = scatter_add_groups([
        (rows4, part.plan_A), (rows4, part.plan_F), (rows2, part.plan_b),
        (rows4, part.plan_C), (rows2, part.plan_bs)])
    A = A * s_int[:, :, None] * s_int[:, None, :] + torch.diag_embed(diag_int)
    F = F * s_int[:, :, None] * s_loc[:, None, :]
    b = -b.reshape(P, ni * D) * s_int
    C = C * s_sep[..., :, None] * s_sep[..., None, :] \
        + torch.diag_embed(diag_sep)
    b_sep = -b_sep.reshape(*sl, ns * D) * s_sep
    return SchurSystem(A, F, b, C, b_sep, s_int, s_sep)


def schur_solve(system: BlockSystem, edges: EdgeSet, part: SchurPartition,
                lam: Tensor, blocked: bool = False, panel: int = 16,
                panel_inner: int = 0, pallas_micro: bool = False) -> Update:
    """Exact damped-normal-equation solve by two-level Schur elimination,
    in the Jacobi-equilibrated space ``D^-1/2 H D^-1/2`` (pose unknowns
    only).  ``blocked`` factors with the panel-blocked Cholesky (panel
    width ``panel``, inner blocking ``panel_inner``, diagonal panels of the
    interiors through the ``micro_chol_inv`` kernel with ``pallas_micro``);
    otherwise the native ops.  ``lam`` is 0-d or per node (:func:`assemble`).
    On a seed batch's partition every step serves all B seeds: the B*P
    interiors in one factorisation, the B separators in another."""
    E, R, D = system.Ja.shape
    dtype, dev = system.Ja.dtype, system.Ja.device
    P, ni, ns, nsk = part.num_blocks, part.ni_max, part.ns, part.nsk_max
    sl, nst = part.sep_lead, part.slots.sep_ids.shape[0]
    with span("schur.assemble"):
        A, F, b, C, b_sep, s_int, s_sep = assemble(system, part, lam)

    # Half substitution: with A = L L^T and G = L^-1 [F | b],
    #   S = C - G_F^T G_F,  rhs_s = b_sep - G_F^T g_b,
    #   x_int = L^-T (g_b - G_F x_sep).
    # Small interiors (D*ni <= _INV_MAX_DIM) form L^-1 explicitly.  The
    # blocked path's large interiors solve [F | b] by cho_solve instead:
    #   Y = A^-1 [F | b],  S = C - F^T Y_F,  x_int = y_b - Y_F x_sep.
    with span("schur.interiors"):
        Fb_ext = torch.cat([F, b[:, :, None]], dim=-1)
        use_inv = ni * D <= _INV_MAX_DIM
        if blocked:
            fac = bc.blocked_cholesky(A, panel=panel, inner=panel_inner,
                                      pallas_micro=pallas_micro)
            if use_inv:
                Linv = bc.solve_lower(fac, bc.eye_like(fac.L))[
                    ..., :ni * D, :ni * D]
        else:
            L, info = torch.linalg.cholesky_ex(A)
            if use_inv:
                Linv = torch.linalg.solve_triangular(L, bc.eye_like(L),
                                                     upper=False)
        if blocked and not use_inv:
            Y_ext = bc.cho_solve_blocked(fac, Fb_ext)
            Y_F, y_b = Y_ext[..., :-1], Y_ext[..., -1]
            S_loc = F.transpose(-1, -2) @ Y_F                 # (P, D*nsk, .)
            r_loc = F.transpose(-1, -2) @ y_b[:, :, None]
        else:
            G_ext = (Linv @ Fb_ext if use_inv else
                     torch.linalg.solve_triangular(L, Fb_ext, upper=False))
            G_F, g_b = G_ext[..., :-1], G_ext[..., -1]
            S_loc = G_F.transpose(-1, -2) @ G_F               # (P, D*nsk, .)
            r_loc = G_F.transpose(-1, -2) @ g_b[:, :, None]
    with span("schur.separator"):
        S_sum, r_sum = scatter_add_groups([
            (_blocks(S_loc, (P,), nsk, nsk, D), part.plan_S),
            (r_loc.reshape(P * nsk, D), part.plan_rs)])
        S = C - S_sum
        rhs_s = b_sep - r_sum.reshape(*sl, ns * D)
        if blocked:
            # One separator per problem (per seed, as under the JAX package's
            # vmap): its panels never take the micro kernel.
            sfac = bc.blocked_cholesky(S, panel=panel, inner=panel_inner)
            x_sep = bc.cho_solve_blocked(sfac, rhs_s)
        else:
            # One separator per problem, each factored as if alone; one
            # problem's is a stack of one.
            Ls, info_s = stack_cholesky(S.reshape((-1,) + S.shape[-2:]))
            x_sep = cho_solve_stack(
                Ls, rhs_s.reshape(Ls.shape[0], -1, 1)).reshape(rhs_s.shape)

    with span("schur.back_substitute"):
        x_loc = (gather_rows(x_sep.reshape(nst, D), part.loc_gather)
                 .reshape(P, nsk, D) * part.loc_mask[:, :, None]
                 ).reshape(P, nsk * D, 1)
        if blocked and not use_inv:
            x_int = y_b - (Y_F @ x_loc)[..., 0]
        else:
            half = (g_b - (G_F @ x_loc)[..., 0])[:, :, None]
            x_int = (Linv.transpose(-1, -2) @ half if use_inv else
                     torch.linalg.solve_triangular(L.transpose(-1, -2), half,
                                                   upper=True))[..., 0]
        # Leave the scaled space and scatter slots back to nodes.
        x_int = x_int * s_int
        x_sep = x_sep * s_sep
        dp = scatter_add_rows(
            torch.cat([x_sep.reshape(nst, D), x_int.reshape(P * ni, D)]),
            part.plan_out)
        if not blocked:  # the blocked factor carries its NaN itself
            dp = nan_unless_factored(nan_unless_factored(dp, info, part.seeds),
                                     info_s, part.seeds)
        return Update(poses=dp,
                      switches=torch.zeros((E,), dtype=dtype, device=dev))
