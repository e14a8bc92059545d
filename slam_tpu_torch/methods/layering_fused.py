"""Method 3 as a device-resident loop (fused probabilistic layering).

Port of ``slam_tpu/methods/layering_fused.py``.  The host engine
(``layering.py``) reads every candidate's costs back to decide; here the
whole decision loop runs on the device, and the host only enqueues:

* Layers are a fixed ``(L, N, 3)`` pose tensor plus ``(L, E)`` masks, and
  the EMA residuals, visits, rewards, successes and last steps as
  ``(L,)`` -- "create a layer" is writing into slot ``num_layers``.
* Per candidate edge, the reference's evaluations (L_e(0), L_i, L_e(k),
  L_ij for the top-3 UCT layers; ``layer_manager.cpp:352-385``) are 10
  short solves run in turn, their costs kept as one (10,) device tensor.
* UCT top-k, the conflict deltas, split or assign, the windowed commit
  (``layer_manager.cpp:137-179``), the EMA residual and the reward
  (``layer_manager.cpp:450-461``) are tensors selected with
  ``torch.where`` and ``index_select`` on 0-d device indices: no value
  the decisions depend on is read on the host.
* Every logged quantity of the host engine is a per-candidate output,
  copied to the host once per chunk; the identical ``[uct] [conflict]
  [split] [assign] [residual] [uct_update]`` lines are written from them
  afterwards (:meth:`FusedLayeringManager._replay`).

Recomputing L_i instead of caching it is exact: a layer's poses change
only when it is the assignment target, which is when the host engine
drops its cache entry.  Dropped TPU workarounds: the width-4 vmap of the
evaluations (``EVAL_CHUNK``) with its two padding solves, and the one-hot
matmul selects (``_sel``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch import runtime
from slam_tpu_torch.config import LayeringConfig, SolverConfig
from slam_tpu_torch.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu_torch.methods import _fused_common as fc
from slam_tpu_torch.methods.layering import LayeringOutput, ShortSolves, \
    _Layer, host_poses, info_gain_np
from slam_tpu_torch.utils.logging import RunLogger

Tensor = torch.Tensor


class _ScanState(NamedTuple):
    poses: Tensor         # (L, N, 3)
    masks: Tensor         # (L, E) 0/1 loop-edge assignment masks
    ema: Tensor           # (L,)
    visits: Tensor        # (L,)
    total_reward: Tensor  # (L,)
    success: Tensor       # (L,) int64
    last_step: Tensor     # (L,) int64
    num_layers: Tensor    # () int64
    step: Tensor          # () int64


class _ScanOut(NamedTuple):
    """Per-candidate decision record -- everything the host engine logs."""

    num_layers_before: np.ndarray
    topk: np.ndarray      # (3,) layer slots (may exceed num_layers)
    uct: np.ndarray       # (3,) scores
    Le0: np.ndarray
    Li: np.ndarray        # (3,)
    Lek: np.ndarray       # (3,)
    Lij: np.ndarray       # (3,)
    delta: np.ndarray     # (3,) (+inf on invalid candidates)
    target: np.ndarray
    did_split: np.ndarray
    split_fallback: np.ndarray
    child: np.ndarray     # slot the child was cloned into (if did_split)
    r_new: np.ndarray
    ema_prev: np.ndarray
    ema_now: np.ndarray
    reward: np.ndarray
    visits_after: np.ndarray
    n_lc: np.ndarray


class _Consts(NamedTuple):
    ss: ShortSolves
    odo: Tensor        # (E,) 1 on odometry edges
    clos: Tensor       # (E,) 1 on closures (not bogus loops)
    info_gain: Tensor  # (E,) 0.5 logdet(I + Omega) of each loop edge


def pick3(v: Tensor) -> tuple[Tensor, Tensor]:
    """Top-3 slots and values by value, first-index tie-breaking (the
    host's stable descending sort): three ``argmax`` calls, each returning
    the first maximum, with the winner masked to ``-inf`` by ``where``
    (never ``0 * inf``, since ``v`` holds ``-inf``)."""
    idx, val = [], []
    iota = torch.arange(v.shape[0], device=v.device)
    for _ in range(3):
        k = torch.argmax(v)
        idx.append(k)
        val.append(v.index_select(0, k.reshape(1))[0])
        v = torch.where(iota == k, -torch.inf, v)
    return torch.stack(idx), torch.stack(val)


def edge_residual(pa: Tensor, pb: Tensor, meas: Tensor,
                  theta_w: float) -> Tensor:
    """Device twin of ``layering._edge_residual_np``
    (``layer_manager.cpp:181-228``)."""
    ca, sa = torch.cos(pa[2]), torch.sin(pa[2])
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    vx = ca * dx + sa * dy - meas[0]
    vy = -sa * dx + ca * dy - meas[1]
    cm, sm = torch.cos(meas[2]), torch.sin(meas[2])
    ex = cm * vx + sm * vy
    ey = -sm * vx + cm * vy
    et = torch.asin(torch.clamp(torch.sin(pb[2] - pa[2] - meas[2]),
                                -1.0, 1.0))
    return torch.sqrt(ex * ex + ey * ey + theta_w * et * et)


def _fused_chunk(state: _ScanState, consts: _Consts, xs: list,
                 cfg: LayeringConfig):
    """One chunk of candidates; ``xs`` = (edge indices (C,), endpoints
    (C, 2)) on the host.  Enqueues every candidate's work and reads
    nothing back; returns the new state and the stacked outputs."""
    ss = consts.ss
    edges, free_first = ss.edges, ss.free_first.node
    dtype, dev = ss.dtype, ss.dev
    L = cfg.max_layers
    N = state.poses.shape[1]
    iota_e = torch.arange(edges.num_edges, device=dev)
    iota_n = torch.arange(N, device=dev)
    iota_l = torch.arange(L, device=dev)
    ea, eb = edges.ij[:, 0], edges.ij[:, 1]
    odo = consts.odo
    iters = max(1, cfg.local_iters)
    commit_iters = max(1, cfg.commit_local_iters)

    s, rows = state, []
    for eidx, (a, b) in zip(xs[0].tolist(), xs[1].tolist()):
        extra = (iota_e == eidx).to(dtype)
        step = s.step + 1

        # -- UCT top-k (layer_manager.cpp:512-531) ------------------------
        valid = (iota_l >= 1) & (iota_l < s.num_layers)
        q = s.total_reward / (1.0 + s.visits)
        total = 1.0 + torch.sum(torch.where(valid, s.visits, 0.0))
        u = cfg.uct_c * torch.sqrt(torch.log(total) / (1.0 + s.visits))
        score = torch.where(valid, q + u, -torch.inf)
        topk, uct = pick3(score)
        # -inf scores sort last, so invalid slots occupy a suffix; they
        # are evaluated all the same and excluded from the decision.
        topk_valid = (topk >= 1) & (topk < s.num_layers)

        # -- candidate evaluations (layer_manager.cpp:352-385) -------------
        tk_poses = s.poses.index_select(0, topk)         # (3, N, 3)
        tk_masks = s.masks.index_select(0, topk)         # (3, E)
        base = torch.maximum(odo, extra)
        specs = [(s.poses[0], base)]                                # L_e(0)
        specs += [(tk_poses[t], torch.maximum(odo, tk_masks[t]))
                  for t in range(3)]                                # L_i
        specs += [(tk_poses[t], base) for t in range(3)]            # L_e(k)
        specs += [(tk_poses[t], torch.maximum(base, tk_masks[t]))
                  for t in range(3)]                                # L_ij
        costs = torch.stack([ss.device_solve(p, act, free_first, iters)[1]
                             for p, act in specs])
        Le0, Li, Lek, Lij = costs[0], costs[1:4], costs[4:7], costs[7:10]

        # -- conflict decision (layer_manager.cpp:388-431) -----------------
        delta = torch.where(topk_valid, Lij - torch.minimum(Li, Lek),
                            torch.inf)
        t = torch.argmin(delta).reshape(1)               # first min == host
        best_delta = delta.index_select(0, t)[0]
        best_Li = Li.index_select(0, t)[0]
        best_Lij = Lij.index_select(0, t)[0]
        target = topk.index_select(0, t)                 # (1,)

        request_split = best_delta > cfg.conflict_tau
        can_split = s.num_layers < L
        did_split = request_split & can_split
        child = s.num_layers
        clone = (iota_l == child) & did_split
        tgt_poses = s.poses.index_select(0, target)[0]
        tgt_mask_pre = s.masks.index_select(0, target)[0]
        poses = torch.where(clone[:, None, None], tgt_poses, s.poses)
        masks = torch.where(clone[:, None], tgt_mask_pre, s.masks)
        num_layers = s.num_layers + did_split.to(s.num_layers.dtype)

        # -- assign + windowed commit (:137-179, 432-437) -------------------
        oh_target = iota_l == target[0]
        masks = torch.where(oh_target[:, None], torch.maximum(masks, extra),
                            masks)
        tgt_mask = torch.maximum(tgt_mask_pre, extra)
        lo = max(0, min(a, b) - cfg.commit_window_radius)
        hi = min(N - 1, max(a, b) + cfg.commit_window_radius)
        edge_in_w = ((ea >= lo) & (ea <= hi) & (eb >= lo) & (eb <= hi)
                     ).to(dtype)
        edge_active = torch.maximum(odo, tgt_mask) * edge_in_w
        free = ((iota_n >= lo) & (iota_n <= hi) & (iota_n != lo)).to(dtype)
        new_tgt, _ = ss.device_solve(tgt_poses, edge_active, free,
                                     commit_iters)
        poses = torch.where(oh_target[:, None, None], new_tgt, poses)

        # -- EMA residual (:440-447) -----------------------------------------
        r = edge_residual(new_tgt[a], new_tgt[b], edges.meas[eidx],
                          cfg.theta_weight)
        ema_prev = s.ema.index_select(0, target)[0]
        ema_now = (1 - cfg.ema_alpha) * ema_prev + cfg.ema_alpha * r
        ema = torch.where(oh_target, ema_now, s.ema)

        # -- reward + UCT backprop (:450-461) ---------------------------------
        dcr = (best_Lij - best_Li) / (cfg.epsilon + best_Li)
        n_lc = torch.sum(tgt_mask * consts.clos)
        reward = torch.clamp(
            -dcr + cfg.alpha_info * consts.info_gain[eidx]
            - cfg.beta_sparse * n_lc, -1.0, 1.0)
        success = ~did_split & (best_delta <= cfg.conflict_tau)
        visits = s.visits + oh_target.to(dtype)
        rows.append(dict(
            num_layers_before=s.num_layers, topk=topk, uct=uct, Le0=Le0,
            Li=Li, Lek=Lek, Lij=Lij, delta=delta, target=target[0],
            did_split=did_split, split_fallback=request_split & ~can_split,
            child=child, r_new=r, ema_prev=ema_prev, ema_now=ema_now,
            reward=reward, visits_after=visits.index_select(0, target)[0],
            n_lc=n_lc))
        s = _ScanState(
            poses=poses, masks=masks, ema=ema, visits=visits,
            total_reward=torch.where(oh_target, s.total_reward + reward,
                                     s.total_reward),
            success=s.success + (oh_target & success).to(s.success.dtype),
            last_step=torch.where(oh_target, step, s.last_step),
            num_layers=num_layers, step=step,
        )
    return s, {k: torch.stack([r[k] for r in rows]) for k in _ScanOut._fields}


def _init_state(poses0: Tensor, L: int, E: int) -> _ScanState:
    kw = dict(dtype=poses0.dtype, device=poses0.device)
    ikw = dict(dtype=torch.int64, device=poses0.device)
    return _ScanState(
        poses=poses0[None].repeat(L, 1, 1),
        masks=torch.zeros((L, E), **kw),
        ema=torch.zeros((L,), **kw),
        visits=torch.zeros((L,), **kw),
        total_reward=torch.zeros((L,), **kw),
        success=torch.zeros((L,), **ikw),
        last_step=torch.zeros((L,), **ikw),
        num_layers=torch.full((), 2, **ikw),
        step=torch.zeros((), **ikw),
    )


def edge_consts(ss: ShortSolves, graph: PoseGraph) -> tuple:
    """(odometry mask, closure mask, info gain per loop edge) on the
    device, in the eval dtype."""
    et = graph.edge_type
    gain = np.zeros(graph.num_edges)
    for e in np.where(et != ODOMETRY_EDGE)[0]:
        gain[e] = info_gain_np(graph.edges_info[e])
    return (ss.tensor(et == ODOMETRY_EDGE), ss.tensor(et == CLOSURE_EDGE),
            ss.tensor(gain))


class FusedLayeringManager:
    """Twin of :class:`layering.LayeringManager` with the decision loop
    on the device.  Same constructor, same ``run()`` contract, same log
    lines (written from the per-candidate outputs)."""

    def __init__(
        self,
        graph: PoseGraph,
        cfg: LayeringConfig,
        solver: SolverConfig | None = None,
        logger: RunLogger | None = None,
        device: str | torch.device | None = "cuda",
        checkpoint_path: str | None = None,
    ):
        runtime.require_type(graph, PoseGraph, "graph")
        runtime.require_type(cfg, LayeringConfig, "cfg")
        self.graph = graph.canonical_order()
        self.cfg = cfg
        self.log = logger or RunLogger()
        self.checkpoint_path = checkpoint_path
        self.ss, self.scan_chunk = fc.setup_eval_solver(
            self.graph, cfg, solver or SolverConfig(), device)
        self.eval_cfg = self.ss.cfg
        self.loop_indices = np.where(self.graph.edge_type != ODOMETRY_EDGE)[0]
        self.ij = self.graph.edges_ij
        self.chunks = 0

        self.log.log("init", layers=2, candidates=len(self.loop_indices),
                     fused=True)

    def run(self) -> LayeringOutput:
        g = self.graph
        cand = self.loop_indices.astype(np.int64)
        consts = _Consts(self.ss, *edge_consts(self.ss, g))
        state = _init_state(self.ss.tensor(g.poses), self.cfg.max_layers,
                            self.ss.edges.num_edges)
        fp = fc.fingerprint(g.poses, g.edges_ij, g.edges_meas, cand,
                            extra=f"m3|{self.cfg}|{self.eval_cfg}")
        # The module attribute is looked up here, so a caller may wrap it.
        state, outs, self.chunks = fc.run_chunked(
            state, _fused_chunk, consts, [cand, g.edges_ij[cand]],
            self.scan_chunk, self.cfg, checkpoint_path=self.checkpoint_path,
            fp=fp)
        return self._replay(state, _ScanOut(**outs))

    # -- host-side replay: identical logs + outputs ------------------------
    def _replay(self, state: _ScanState, o: _ScanOut) -> LayeringOutput:
        num_layers = int(state.num_layers)
        assignments = []
        for i, eidx in enumerate(self.loop_indices):
            nl = int(o.num_layers_before[i])
            topk = [int(k) for k in o.topk[i] if 1 <= int(k) < nl]
            self.log.log("uct", topk=",".join(
                f"L{k}({float(o.uct[i][t]):.4f})" for t, k in enumerate(topk)
            ))
            for t, k in enumerate(topk):
                self.log.log(
                    "conflict", edge_idx=i, try_layer=k,
                    L_i=float(o.Li[i][t]), L_e_k=float(o.Lek[i][t]),
                    L_ij=float(o.Lij[i][t]), Delta=float(o.delta[i][t]),
                )
            target = int(o.target[i])
            best_delta = float(o.delta[i][int(np.argmin(o.delta[i]))])
            if bool(o.did_split[i]):
                self.log.log("layer", created=int(o.child[i]), parent=target)
                self.log.log("split", edge_idx=i, Delta=best_delta,
                             child_layer=int(o.child[i]),
                             parent_assigned_layer=target)
            elif bool(o.split_fallback[i]):
                self.log.log("split-fallback", edge_idx=i, Delta=best_delta,
                             fallback_layer=target)
            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log("assign", edge_idx=i, a=a, b=b,
                         type=int(self.graph.edge_type[eidx]),
                         to_layer=target)
            assignments.append((i, target))
            self.log.log("residual", layer=target, r_new=float(o.r_new[i]),
                         ema_prev=float(o.ema_prev[i]),
                         ema_now=float(o.ema_now[i]))
            self.log.log("uct_update", layer=target,
                         visits=float(o.visits_after[i]),
                         reward=float(o.reward[i]))

        st = {k: v.cpu().numpy() for k, v in state._asdict().items()
              if k != "poses"}
        layers = [
            _Layer(
                poses=state.poses[k],
                mask=st["masks"][k] > 0.5,
                ema_residual=float(st["ema"][k]),
                num_edges=int(np.sum(st["masks"][k] > 0.5)),
                visits=float(st["visits"][k]),
                total_reward=float(st["total_reward"][k]),
                success=int(st["success"][k]),
                last_step=int(st["last_step"][k]),
            )
            for k in range(num_layers)
        ]
        best = min(range(1, num_layers),
                   key=lambda k: layers[k].ema_residual)
        most = max(range(1, num_layers),
                   key=lambda k: int(layers[k].mask.sum()))
        self.log.log("finish", best_layer=best,
                     ema=layers[best].ema_residual)
        self._print_summary(layers, most)
        return LayeringOutput(
            poses=host_poses(layers[best].poses),
            layers=layers,
            assignments=assignments,
            best_layer=best,
            most_selected_layer=most,
        )

    def _print_summary(self, layers, most: int) -> None:
        self.log.log("summary", msg="==== Method3 Summary ====")
        self.log.log("summary", total_layers=len(layers) - 1)
        self.log.log("summary", most_selected_layer=f"L{most}",
                     edges=int(layers[most].mask.sum()))
        for k in range(1, len(layers)):
            lay = layers[k]
            nodes = set()
            for e in np.where(lay.mask)[0]:
                nodes.add(int(self.ij[e, 0]))
                nodes.add(int(self.ij[e, 1]))
            self.log.log(
                "summary", layer=f"L{k}", edges=int(lay.mask.sum()),
                nodes=len(nodes), visits=int(lay.visits),
                success=lay.success, total_reward=lay.total_reward,
                avg_reward=lay.total_reward / (1.0 + lay.visits),
                ema_residual=lay.ema_residual,
            )
