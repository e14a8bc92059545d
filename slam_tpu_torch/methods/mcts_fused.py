"""Method 4 (MCTS layer tree) as a device-resident loop.

Port of ``slam_tpu/methods/mcts_fused.py``: the same re-architecture as
``layering_fused.py`` applied to the reference's
``simple_layer_manager.cpp``, with the layer *tree* flattened into
fixed-size device tensors:

* ``parent (L,)`` slot pointers (root slot 0, -1 for none) -- creation
  order equals slot order, matching the host engine's ``L{k+1}`` ids;
* ``inherited/added (L, E)`` masks, ``poses (L, N, 3)``,
  ``visits``/``total_reward (L,)``.

Per candidate edge, the device work mirrors the host's call pattern: the
3-way split check (``:173-211``), the commit solve on the child's window
or on the full layer (``:500-565`` / ``:457-498``), selected by
``did_split``, and the 2-solve reward (``:293-339``).  The split check's
3 solves and the reward's 2 are each one ``lm_fixed_iters`` call folded
over their lanes (``ShortSolves.device_costs``; the stacked plans of
widths 3 and 2 built before the first chunk, on every eval), the commit
one solve.  UCT selection with
unvisited-first (``:132-171``), the Mahalanobis gate (``:388-455``) and
the parent-chain backprop (``:624-641``, exactly L steps of pointer
chasing) are tensors too; the host reads nothing inside a chunk but
the PCG eval's CG stopping flag.  The
host engine (``mcts.py``) stays the readable reference, and the replay
writes its log lines.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch import runtime
from slam_tpu_torch.config import MctsConfig, SolverConfig
from slam_tpu_torch.graph import ODOMETRY_EDGE, PoseGraph
from slam_tpu_torch.methods import _fused_common as fc
from slam_tpu_torch.methods.layering import ShortSolves, host_poses, \
    info_gain_np
from slam_tpu_torch.methods.layering_fused import edge_consts
from slam_tpu_torch.methods.mcts import MctsOutput, _TreeLayer
from slam_tpu_torch.utils.logging import RunLogger

Tensor = torch.Tensor


class _TreeState(NamedTuple):
    poses: Tensor         # (L, N, 3)
    inherited: Tensor     # (L, E)
    added: Tensor         # (L, E)
    visits: Tensor        # (L,)
    total_reward: Tensor  # (L,)
    parent: Tensor        # (L,) int64, -1 = none
    num_layers: Tensor    # () int64
    step: Tensor          # () int64


class _TreeOut(NamedTuple):
    num_layers_before: np.ndarray
    selected: np.ndarray
    residual: np.ndarray
    gate: np.ndarray          # residual < residual_high
    did_check: np.ndarray     # split check evaluated (and logged)
    c_cur: np.ndarray
    c_new: np.ndarray
    c_comb: np.ndarray
    split_value: np.ndarray
    did_split: np.ndarray
    target: np.ndarray
    Li: np.ndarray
    Li_prev: np.ndarray
    dcr: np.ndarray
    n_closure: np.ndarray
    reward: np.ndarray


class _Consts(NamedTuple):
    ss: ShortSolves
    odo: Tensor        # (E,) 1 on odometry edges
    clos: Tensor       # (E,) 1 on closures (not bogus loops)
    info_gain: Tensor  # (E,) 0.5 logdet(I + Omega) of each loop edge
    sym: Tensor        # (9,) the information matrix's entries in info6


def _wrap(t: Tensor) -> Tensor:
    """Angle wrap to (-pi, pi] (the reference's subtract-2pi loop,
    ``simple_layer_manager.cpp:430-441``, closed form)."""
    two_pi = 2.0 * np.pi
    return t - two_pi * torch.floor((t + np.pi) / two_pi)


def _fused_chunk(state: _TreeState, consts: _Consts, xs: list,
                 cfg: MctsConfig):
    """One chunk of candidates; ``xs`` = (edge indices (C,), endpoints
    (C, 2)) on the host.  Enqueues every candidate's work and reads
    nothing back; returns the new state and the stacked outputs."""
    ss = consts.ss
    edges, free_all = ss.edges, ss.free_first.node
    dtype, dev = ss.dtype, ss.dev
    L = cfg.max_layers
    N = state.poses.shape[1]
    iota_e = torch.arange(edges.num_edges, device=dev)
    iota_n = torch.arange(N, device=dev)
    iota_l = torch.arange(L, device=dev)
    ea, eb = edges.ij[:, 0], edges.ij[:, 1]
    odo = consts.odo
    iters = max(1, cfg.local_iters)
    radius = max(1, cfg.local_window // 2)

    def costs(poses, actives):
        """One-iteration solve costs from one start point (the host's
        ``_eval_costs`` batches; ``evaluate_layer_cost`` semantics), one
        folded call over the lanes."""
        return ss.device_costs(poses.expand(len(actives), -1, -1),
                               torch.stack(actives), 1).unbind()

    s, rows = state, []
    for eidx, (a, b) in zip(xs[0].tolist(), xs[1].tolist()):
        extra = (iota_e == eidx).to(dtype)
        step = s.step + 1
        valid = iota_l < s.num_layers

        # -- UCT selection, unvisited-first (:132-171) ----------------------
        unvisited = valid & (s.visits == 0)
        total = torch.clamp(torch.sum(torch.where(valid, s.visits, 0.0)),
                            min=1.0)
        vsafe = torch.clamp(s.visits, min=1.0)
        val = s.total_reward / vsafe + cfg.exploration_c * torch.sqrt(
            torch.log(total) / vsafe)
        val = torch.where(valid & (s.visits > 0), val, -torch.inf)
        selected = torch.where(torch.any(unvisited),
                               torch.argmax(unvisited.to(torch.int32)),
                               torch.argmax(val)).reshape(1)
        sel_poses = s.poses.index_select(0, selected)[0]
        sel_inh = s.inherited.index_select(0, selected)[0]
        sel_add = s.added.index_select(0, selected)[0]
        sel_all = torch.maximum(sel_inh, sel_add)

        # -- Mahalanobis gate (:388-455) ------------------------------------
        pa, pb = sel_poses[a], sel_poses[b]
        meas = edges.meas[eidx]
        dx, dy = pb[0] - pa[0], pb[1] - pa[1]
        ca, sa = torch.cos(pa[2]), torch.sin(pa[2])
        r = torch.stack([
            ca * dx + sa * dy - meas[0],
            -sa * dx + ca * dy - meas[1],
            _wrap(_wrap(pb[2] - pa[2]) - meas[2]),
        ])
        O = edges.info[eidx].index_select(0, consts.sym).reshape(3, 3)
        residual = torch.sqrt(torch.clamp(r @ O @ r, min=0.0))
        gate = residual < cfg.residual_high

        # -- split check (:173-211) ------------------------------------------
        has_added = torch.any(sel_add > 0)
        can_split = s.num_layers < L
        base = torch.maximum(odo, sel_inh)
        c_cur, c_new, c_comb = costs(sel_poses, (
            torch.maximum(base, sel_add),                        # current
            torch.maximum(base, extra),                          # new only
            torch.maximum(base, torch.maximum(sel_add, extra))))  # combined
        split_value = c_comb - torch.minimum(c_cur, c_new)
        did_check = gate & can_split & has_added
        did_split = did_check & (split_value > cfg.conflict_tau)

        # -- targets / mask updates ------------------------------------------
        child = s.num_layers
        target = torch.where(did_split, child, selected[0])
        inh_t = torch.where(did_split, sel_all, sel_inh)
        added_t = torch.where(did_split, extra, torch.maximum(sel_add, extra))
        upd = gate & (iota_l == target)
        inherited = torch.where(upd[:, None], inh_t, s.inherited)
        added = torch.where(upd[:, None], added_t, s.added)
        parent = torch.where((iota_l == child) & did_split & gate,
                             selected[0], s.parent)
        num_layers = s.num_layers + (did_split & gate).to(s.num_layers.dtype)

        # -- commit: the child's local window (:500-565) or the full layer
        #    (:457-498).  Window nodes lie within radius of either endpoint
        #    of the (single) added edge; an odometry edge is active iff both
        #    its endpoints are window nodes (:500-530). -----------------------
        na = ((ea - a).abs() <= radius) | ((ea - b).abs() <= radius)
        nb = ((eb - a).abs() <= radius) | ((eb - b).abs() <= radius)
        win_active = torch.maximum(odo * (na & nb).to(dtype), extra)
        used = edges.node_sums((win_active, win_active))[0] > 0
        anchor = torch.where(used[0], 0,
                             torch.argmax(used.to(torch.int32)))
        win_free = (used & (iota_n != anchor)).to(dtype)
        full_active = torch.maximum(odo, torch.maximum(inh_t, added_t))
        opt_poses, _ = ss.device_solve(
            sel_poses, torch.where(did_split, win_active, full_active),
            torch.where(did_split, win_free, free_all), iters)
        poses = torch.where(upd[:, None, None], opt_poses, s.poses)

        # -- reward (:293-339) ------------------------------------------------
        base_t = torch.maximum(odo, inh_t)
        Li, Li_prev = costs(opt_poses, (
            torch.maximum(base_t, added_t),
            torch.maximum(base_t, added_t * (1 - extra))))
        dcr = (Li - Li_prev) / (cfg.epsilon + Li_prev)
        # The reference double-counts the new closure (:367-386).
        n_closure = torch.sum(torch.maximum(inh_t, added_t) * consts.clos) \
            + consts.clos[eidx]
        reward = torch.clamp(
            -dcr + cfg.alpha_info * consts.info_gain[eidx]
            - cfg.beta_sparse * n_closure, -1.0, 1.0)

        # -- backprop up the parent chain (:624-641): exactly L steps --------
        cur, visits, total_reward = target, s.visits, s.total_reward
        for _ in range(L):
            hit = (iota_l == cur) & gate            # cur = -1 hits nothing
            visits = torch.where(hit, visits + 1.0, visits)
            total_reward = torch.where(hit, total_reward + reward,
                                       total_reward)
            nxt = parent.index_select(0, torch.clamp(cur, min=0).reshape(1))
            cur = torch.where(cur >= 0, nxt[0], -1)

        rows.append(dict(
            num_layers_before=s.num_layers, selected=selected[0],
            residual=residual, gate=gate, did_check=did_check,
            c_cur=c_cur, c_new=c_new, c_comb=c_comb,
            split_value=split_value, did_split=did_split & gate,
            target=target, Li=Li, Li_prev=Li_prev, dcr=dcr,
            n_closure=n_closure, reward=reward))
        s = _TreeState(
            poses=poses, inherited=inherited, added=added, visits=visits,
            total_reward=total_reward, parent=parent,
            num_layers=num_layers, step=step,
        )
    return s, {k: torch.stack([r[k] for r in rows]) for k in _TreeOut._fields}


def _init_state(poses0: Tensor, L: int, E: int) -> _TreeState:
    kw = dict(dtype=poses0.dtype, device=poses0.device)
    ikw = dict(dtype=torch.int64, device=poses0.device)
    return _TreeState(
        poses=poses0[None].repeat(L, 1, 1),
        inherited=torch.zeros((L, E), **kw),
        added=torch.zeros((L, E), **kw),
        visits=torch.zeros((L,), **kw),
        total_reward=torch.zeros((L,), **kw),
        parent=torch.full((L,), -1, **ikw),
        num_layers=torch.full((), 1, **ikw),
        step=torch.zeros((), **ikw),
    )


class FusedMctsManager:
    """Twin of :class:`mcts.MctsManager` with the decision loop on the
    device; identical decisions and log lines (see the module
    docstring)."""

    root_id = "L1"

    def __init__(
        self,
        graph: PoseGraph,
        cfg: MctsConfig,
        solver: SolverConfig | None = None,
        logger: RunLogger | None = None,
        device: str | torch.device | None = "cuda",
        checkpoint_path: str | None = None,
    ):
        runtime.require_type(graph, PoseGraph, "graph")
        runtime.require_type(cfg, MctsConfig, "cfg")
        self.graph = graph.canonical_order()
        self.cfg = cfg
        self.log = logger or RunLogger()
        self.checkpoint_path = checkpoint_path
        self.ss, self.scan_chunk = fc.setup_eval_solver(
            self.graph, cfg, solver or SolverConfig(), device,
            widths=(3, 2))
        self.eval_cfg = self.ss.cfg
        self.loop_indices = np.where(self.graph.edge_type != ODOMETRY_EDGE)[0]
        self.ij = self.graph.edges_ij
        self.chunks = 0

        self.log.log("init", msg="MCTS layer manager (method 4)",
                     candidates=len(self.loop_indices),
                     max_layers=cfg.max_layers, fused=True)

    def run(self) -> MctsOutput:
        g = self.graph
        cand = self.loop_indices.astype(np.int64)
        # [[i0 i1 i2] [i1 i3 i4] [i2 i4 i5]], row-major, from info6.
        sym = torch.tensor([0, 1, 2, 1, 3, 4, 2, 4, 5], device=self.ss.dev)
        consts = _Consts(self.ss, *edge_consts(self.ss, g), sym)
        state = _init_state(self.ss.tensor(g.poses), self.cfg.max_layers,
                            self.ss.edges.num_edges)
        fp = fc.fingerprint(g.poses, g.edges_ij, g.edges_meas, cand,
                            extra=f"m4|{self.cfg}|{self.eval_cfg}")
        # The module attribute is looked up here, so a caller may wrap it.
        state, outs, self.chunks = fc.run_chunked(
            state, _fused_chunk, consts, [cand, g.edges_ij[cand]],
            self.scan_chunk, self.cfg, checkpoint_path=self.checkpoint_path,
            fp=fp)
        return self._replay(state, _TreeOut(**outs))

    def _replay(self, state: _TreeState, o: _TreeOut) -> MctsOutput:
        g = self.graph
        st = {k: v.cpu().numpy() for k, v in state._asdict().items()
              if k != "poses"}
        num_layers = int(st["num_layers"])
        ids = [f"L{k + 1}" for k in range(num_layers)]
        layers: dict[str, _TreeLayer] = {}
        for k in range(num_layers):
            par = int(st["parent"][k])
            layers[ids[k]] = _TreeLayer(
                id=ids[k], parent=ids[par] if par >= 0 else "",
                poses=state.poses[k],
                inherited=st["inherited"][k] > 0.5,
                added=st["added"][k] > 0.5,
                visits=int(round(float(st["visits"][k]))),
                total_reward=float(st["total_reward"][k]),
            )
        for k in range(num_layers):
            par = int(st["parent"][k])
            if par >= 0:
                layers[ids[par]].children.append(ids[k])

        assignments = []
        vis = np.zeros(num_layers)
        tr = np.zeros(num_layers)
        for i, eidx in enumerate(self.loop_indices):
            eidx = int(eidx)
            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log(f"step {i + 1}",
                         msg=f"edge ({a},{b}) "
                             f"type={int(g.edge_type[eidx])}")
            self.log.log("residual", edge_residual=float(o.residual[i]),
                         low=self.cfg.residual_low,
                         high=self.cfg.residual_high)
            if not bool(o.gate[i]):
                self.log.log("skip", msg="edge residual too high")
                continue
            sel_id = ids[int(o.selected[i])]
            if bool(o.did_check[i]):
                self.log.log(
                    "split_check", layer=sel_id,
                    cost_current=float(o.c_cur[i]),
                    cost_new_only=float(o.c_new[i]),
                    cost_combined=float(o.c_comb[i]),
                    should_split=bool(o.did_split[i]),
                    split_value=float(o.split_value[i]),
                )
            t = int(o.target[i])
            tgt_id = ids[t]
            assignments.append((eidx, tgt_id))
            self.log.log("reward", layer=tgt_id,
                         delta_cost_rel=float(o.dcr[i]),
                         info_gain=info_gain_np(g.edges_info[eidx]),
                         n_closure=int(round(float(o.n_closure[i]))),
                         final_reward=float(o.reward[i]))
            cur = t
            while cur >= 0:
                vis[cur] += 1
                tr[cur] += float(o.reward[i])
                self.log.log("backprop", layer=ids[cur],
                             visits=int(vis[cur]), total_reward=tr[cur])
                cur = int(st["parent"][cur])
            if bool(o.did_split[i]):
                self.log.log("expand", created=tgt_id,
                             parent=sel_id, reward=float(o.reward[i]))
            else:
                self.log.log("assign", layer=tgt_id,
                             reward=float(o.reward[i]))

        # result selection (:643-703)
        def normalized(lay):
            return lay.total_reward / np.sqrt(
                1.0 + int(lay.all_edges.sum())
            )

        best, best_val = ids[0], -1e9
        for lid, lay in layers.items():
            if lay.visits > 0 and normalized(lay) > best_val:
                best_val, best = normalized(lay), lid
        most_visited = max(layers.values(), key=lambda l: l.visits).id
        most_edges = max(
            layers.values(), key=lambda l: int(l.all_edges.sum())
        ).id
        self.log.log("summary", msg="===== METHOD 4 SUMMARY =====",
                     total_layers=len(layers), best=best,
                     most_visited=most_visited, most_edges=most_edges)
        return MctsOutput(
            poses=host_poses(layers[best].poses),
            layers=layers,
            assignments=assignments,
            best_layer=best,
            most_visited_layer=most_visited,
            most_edges_layer=most_edges,
        )
