"""Method 3: probabilistic layering with UCT selection (SimpleLayerManager).

Port of the host-driven engine of ``slam_tpu/methods/layering.py``, itself
a behavioural port of the reference's ``layer_manager.cpp``: the same
decision procedure, log tags and ``save/`` files.

* A layer is a pose tensor on the device plus a boolean edge mask over the
  canonical edge arrays; "building a Ceres problem per candidate" is
  flipping mask bits.
* The per-edge candidate evaluations (L_e, L_i, L_e(k), L_ij for the top-k
  UCT layers; ``layer_manager.cpp:352-385``) are one batch of short LM
  solves whose costs are read back together.
* The windowed commit optimisation (``optimize_layer_local``, radius 30,
  1 iteration, anchor = first in-window node; ``layer_manager.cpp:137-179``)
  is a masked solve with a restricted free mask.

The decision loop itself (UCT bookkeeping, split logic, EMA) is host NumPy:
O(closures * k) scalar work.  The short solves run on the dense solver up to
2048 nodes and on PCG above, on every device (the JAX package's switch to
PCG on accelerators was a TPU compile-time workaround).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from slam_tpu_torch import runtime
from slam_tpu_torch.config import LayeringConfig, RunConfig, SolverConfig
from slam_tpu_torch.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu_torch.io import g2o
from slam_tpu_torch.methods import batched
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.utils.logging import RunLogger

#: Largest graph whose short solves take the dense solver (PCG above).
DENSE_MAX_NODES = 2048


@dataclasses.dataclass
class _Layer:
    poses: torch.Tensor      # (N, 3) on the device, in the eval dtype
    mask: np.ndarray         # (E,) bool -- loop edges assigned to this layer
    ema_residual: float = 0.0
    num_edges: int = 0
    visits: float = 0.0
    total_reward: float = 0.0
    success: int = 0
    last_step: int = 0


@dataclasses.dataclass
class LayeringOutput:
    poses: np.ndarray              # best layer's poses
    layers: list                   # final layer states
    assignments: list              # (edge_idx, layer_idx)
    best_layer: int
    most_selected_layer: int


def eval_solver_config(solver: SolverConfig, cfg, num_nodes: int,
                       linear: str | None = None) -> SolverConfig:
    """The short solves' configuration (methods 3 and 4): plain residuals
    under Huber only (``layer_manager.cpp:114-122``), the linear solver
    ``linear`` or else the host engines' rule (the dense solver up to
    :data:`DENSE_MAX_NODES` nodes and PCG above unless the caller names
    one), and the eval trust region and PCG accuracy of ``cfg``."""
    if linear is None:
        linear = solver.linear_solver
        if linear in ("auto", "schur"):
            linear = "dense" if num_nodes <= DENSE_MAX_NODES else "pcg"
    extra = {}
    if linear == "pcg":
        extra = dict(pcg_rtol=cfg.eval_pcg_rtol,
                     pcg_max_iters=cfg.eval_pcg_max_iters)
    return solver.replace(robust="none", huber_delta=cfg.huber_delta,
                          linear_solver=linear,
                          trust_region=cfg.eval_trust_region, **extra)


def host_poses(poses: torch.Tensor) -> np.ndarray:
    """A device pose tensor as host float64 (the values the JAX engine
    holds after its f32 -> f64 read-back)."""
    return poses.cpu().numpy().astype(np.float64)


def host_rows(poses: torch.Tensor, *rows: int) -> np.ndarray:
    """Rows of a device pose tensor as host float64."""
    return host_poses(poses[list(rows)])


def _edge_residual_np(pa, pb, meas, theta_weight=1.0) -> float:
    """Host-side scalar L2 edge residual (``layer_manager.cpp:181-228``)."""
    ca, sa = np.cos(pa[2]), np.sin(pa[2])
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    vx = ca * dx + sa * dy - meas[0]
    vy = -sa * dx + ca * dy - meas[1]
    cm, sm = np.cos(meas[2]), np.sin(meas[2])
    ex = cm * vx + sm * vy
    ey = -sm * vx + cm * vy
    et = np.arcsin(np.clip(np.sin(pb[2] - pa[2] - meas[2]), -1.0, 1.0))
    return float(np.sqrt(ex * ex + ey * ey + theta_weight * et * et))


def info_gain_np(info6) -> float:
    """0.5 * logdet(I + Omega) (``layer_manager.cpp:284-298``)."""
    i = info6
    O = np.array(
        [[i[0], i[1], i[2]], [i[1], i[3], i[4]], [i[2], i[4], i[5]]]
    )
    O = 0.5 * (O + O.T)
    evals = np.clip(np.linalg.eigvalsh(O), 1e-12, None)
    return float(0.5 * np.sum(np.log1p(evals)))


class ShortSolves:
    """The edge set, gauge, plan and configuration of a manager's short
    solves on one device, and their count."""

    def __init__(self, graph: PoseGraph, eval_cfg: SolverConfig, device,
                 schur_blocks: int = 16):
        self.dev = runtime.setup_device(device)
        self.cfg = eval_cfg
        self.dtype = getattr(torch, eval_cfg.dtype)
        self.edges = edge_set_from_graph(graph, dtype=self.dtype,
                                         device=self.dev)
        self.free_first = anchor_first_node(graph.num_nodes,
                                            dtype=self.dtype,
                                            device=self.dev)
        self.plan = batched.eval_plan(eval_cfg, self.edges, graph,
                                      schur_blocks)
        self.solves = 0
        self.iterations = 0

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.dev)

    def costs(self, specs, num_iters: int) -> np.ndarray:
        """Final costs of ``num_iters``-iteration solves of the (poses,
        bool edge mask) specs, anchored at node 0, read back at once."""
        poses = [p for p, _ in specs]
        actives = self.tensor(np.stack([m for _, m in specs]))
        self._count(len(poses), num_iters)
        return batched.batched_eval_cost(
            poses, actives, self.edges, self.free_first, self.cfg,
            num_iters, self.plan).cpu().numpy()

    def solve(self, poses, mask: np.ndarray, free, num_iters: int
              ) -> torch.Tensor:
        """Poses after a masked solve; ``free`` is a host (N,) array or
        the device free mask."""
        if isinstance(free, np.ndarray):
            free = self.tensor(free)
        self._count(1, num_iters)
        out, _ = batched.masked_solve(poses, self.tensor(mask), free,
                                      self.edges, self.cfg, num_iters,
                                      self.plan)
        return out

    def device_solve(self, poses, active, free_node, num_iters: int):
        """``(poses, cost)`` of a masked solve whose masks are device
        tensors, left on the device (the fused engines' solves)."""
        self._count(1, num_iters)
        return batched.masked_solve(poses, active, free_node, self.edges,
                                    self.cfg, num_iters, self.plan)

    def _count(self, n: int, num_iters: int) -> None:
        self.solves += n
        self.iterations += n * num_iters


class LayeringManager:
    """Sequential probabilistic layering (see module docstring)."""

    def __init__(
        self,
        graph: PoseGraph,
        cfg: LayeringConfig,
        solver: SolverConfig | None = None,
        logger: RunLogger | None = None,
        device: str | torch.device | None = "cuda",
    ):
        runtime.require_type(graph, PoseGraph, "graph")
        runtime.require_type(cfg, LayeringConfig, "cfg")
        self.graph = graph.canonical_order()
        self.cfg = cfg
        self.log = logger or RunLogger()

        self.eval_cfg = eval_solver_config(solver or SolverConfig(), cfg,
                                           self.graph.num_nodes)
        self.ss = ShortSolves(self.graph, self.eval_cfg, device)
        self.E = self.ss.edges.num_edges
        et = self.graph.edge_type
        self.odo_mask = et == ODOMETRY_EDGE
        self.loop_indices = np.where(et != ODOMETRY_EDGE)[0]
        self.edge_info = self.graph.edges_info
        self.ij = self.graph.edges_ij
        self.meas = self.graph.edges_meas

        # Layer 0: odometry baseline poses (``layer_manager.cpp:33-37``);
        # one initial working layer (``layer_manager.cpp:40``).
        base = self.ss.tensor(self.graph.poses)
        self.layers: list[_Layer] = [
            _Layer(poses=base.clone(), mask=np.zeros(self.E, bool)),
            _Layer(poses=base.clone(), mask=np.zeros(self.E, bool)),
        ]
        self.Li_cache: dict[int, float] = {}
        self.assignments: list[tuple[int, int]] = []
        self.step = 0

        self.log.log("init", layers=len(self.layers),
                     candidates=len(self.loop_indices))

    # -- UCT ---------------------------------------------------------------
    def _uct_score(self, k: int) -> float:
        st = self.layers[k]
        q = st.total_reward / (1.0 + st.visits)
        total = 1.0 + sum(l.visits for l in self.layers[1:])
        u = self.cfg.uct_c * np.sqrt(np.log(total) / (1.0 + st.visits))
        return q + u

    def _pick_topk(self) -> list[int]:
        idx = list(range(1, len(self.layers)))
        idx.sort(key=self._uct_score, reverse=True)
        return idx[: self.cfg.uct_top_k]

    # -- layer ops ---------------------------------------------------------
    def _create_layer_from(self, base: int) -> int | None:
        if len(self.layers) >= self.cfg.max_layers:
            return None
        src = self.layers[base]
        self.layers.append(
            _Layer(poses=src.poses.clone(), mask=src.mask.copy())
        )
        self.log.log("layer", created=len(self.layers) - 1, parent=base)
        return len(self.layers) - 1

    def _optimize_local(self, k: int, eidx: int) -> None:
        """Window-local commit optimisation (``layer_manager.cpp:137-179``)."""
        a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
        n = self.graph.num_nodes
        lo = max(0, min(a, b) - self.cfg.commit_window_radius)
        hi = min(n - 1, max(a, b) + self.cfg.commit_window_radius)
        in_window = np.zeros(n, bool)
        in_window[lo : hi + 1] = True

        lay = self.layers[k]
        edge_active = (self.odo_mask | lay.mask) & (
            in_window[self.ij[:, 0]] & in_window[self.ij[:, 1]]
        )
        free = in_window.astype(np.float64)
        free[lo] = 0.0  # anchor = first in-window node (:167-169)
        lay.poses = self.ss.solve(lay.poses, edge_active, free,
                                  max(1, self.cfg.commit_local_iters))

    # -- main loop ---------------------------------------------------------
    def run(self) -> LayeringOutput:
        cfg = self.cfg
        iters = max(1, cfg.local_iters)
        for i, eidx in enumerate(self.loop_indices):
            self.step += 1
            eidx = int(eidx)
            extra = np.zeros(self.E, bool)
            extra[eidx] = True

            topk = self._pick_topk()
            self.log.log(
                "uct",
                topk=",".join(
                    f"L{k}({self._uct_score(k):.4f})" for k in topk
                ),
            )

            # One batch: [L_e(base 0)] + [L_i(k) misses] + [L_e(k)] +
            # [L_ij(k)].
            specs = [(self.layers[0].poses, self.odo_mask | extra)]
            li_miss = [k for k in topk if self.Li_cache.get(k) is None]
            for k in li_miss:
                specs.append(
                    (self.layers[k].poses, self.odo_mask | self.layers[k].mask)
                )
            for k in topk:
                specs.append((self.layers[k].poses, self.odo_mask | extra))
            for k in topk:
                specs.append(
                    (
                        self.layers[k].poses,
                        self.odo_mask | self.layers[k].mask | extra,
                    )
                )
            costs = self.ss.costs(specs, iters)

            pos = 1
            for k in li_miss:
                self.Li_cache[k] = float(costs[pos])
                pos += 1
            Le_k = {k: float(costs[pos + t]) for t, k in enumerate(topk)}
            pos += len(topk)
            Lij = {k: float(costs[pos + t]) for t, k in enumerate(topk)}

            best_delta, best_layer, best_Li, best_Lij = 1e100, -1, 0.0, 0.0
            for k in topk:
                L_i = self.Li_cache[k]
                delta = Lij[k] - min(L_i, Le_k[k])
                self.log.log(
                    "conflict", edge_idx=i, try_layer=k, L_i=L_i,
                    L_e_k=Le_k[k], L_ij=Lij[k], Delta=delta,
                )
                if delta < best_delta:
                    best_delta, best_layer = delta, k
                    best_Li, best_Lij = L_i, Lij[k]

            target = best_layer
            request_split = best_layer < 0 or best_delta > cfg.conflict_tau
            did_split = False
            if request_split:
                created = (
                    self._create_layer_from(best_layer)
                    if best_layer >= 1
                    else self._create_layer_from(0)
                )
                if created is not None:
                    # Child cloned; the edge goes to the *parent*
                    # (``layer_manager.cpp:407-418``).
                    target = best_layer if best_layer >= 1 else created
                    did_split = True
                    self.log.log("split", edge_idx=i, Delta=best_delta,
                                 child_layer=created,
                                 parent_assigned_layer=target)
                else:
                    target = best_layer if best_layer >= 1 else 1
                    self.log.log("split-fallback", edge_idx=i,
                                 Delta=best_delta, fallback_layer=target)

            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log("assign", edge_idx=i, a=a, b=b,
                         type=int(self.graph.edge_type[eidx]),
                         to_layer=target)
            self.layers[target].mask[eidx] = True
            self.assignments.append((i, target))

            ema_prev = self.layers[target].ema_residual
            self._optimize_local(target, eidx)
            self.Li_cache.pop(target, None)

            lay = self.layers[target]
            pa, pb = host_rows(lay.poses, a, b)
            r = _edge_residual_np(pa, pb, self.meas[eidx], cfg.theta_weight)
            lay.ema_residual = (1 - cfg.ema_alpha) * lay.ema_residual + cfg.ema_alpha * r
            lay.num_edges += 1
            self.log.log("residual", layer=target, r_new=r,
                         ema_prev=ema_prev, ema_now=lay.ema_residual)

            # Reward shaping (``layer_manager.cpp:450-461``).
            delta_cost_rel = (best_Lij - best_Li) / (cfg.epsilon + best_Li)
            info_gain = info_gain_np(self.edge_info[eidx])
            n_lc = int(
                np.sum(
                    lay.mask
                    & (self.graph.edge_type == CLOSURE_EDGE)
                )
            )
            reward = float(
                np.clip(
                    -delta_cost_rel + cfg.alpha_info * info_gain
                    - cfg.beta_sparse * n_lc,
                    -1.0, 1.0,
                )
            )
            success = (not did_split) and best_delta <= cfg.conflict_tau
            lay.visits += 1.0
            lay.total_reward += reward
            lay.success += int(success)
            lay.last_step = self.step
            self.log.log("uct_update", layer=target, visits=lay.visits,
                         reward=reward)

        return self._finish()

    def _finish(self) -> LayeringOutput:
        # Best = min EMA residual among non-odometry layers
        # (``layer_manager.cpp:556-562``).
        best = min(
            range(1, len(self.layers)),
            key=lambda k: self.layers[k].ema_residual,
        )
        most = max(
            range(1, len(self.layers)),
            key=lambda k: int(self.layers[k].mask.sum()),
        )
        self.log.log("finish", best_layer=best,
                     ema=self.layers[best].ema_residual)
        self._print_summary(most)
        return LayeringOutput(
            poses=host_poses(self.layers[best].poses),
            layers=self.layers,
            assignments=self.assignments,
            best_layer=best,
            most_selected_layer=most,
        )

    def _print_summary(self, most: int) -> None:
        self.log.log("summary", msg="==== Method3 Summary ====")
        self.log.log("summary", total_layers=len(self.layers) - 1)
        self.log.log("summary",
                     most_selected_layer=f"L{most}",
                     edges=int(self.layers[most].mask.sum()))
        for k in range(1, len(self.layers)):
            lay = self.layers[k]
            nodes = set()
            for e in np.where(lay.mask)[0]:
                nodes.add(int(self.ij[e, 0]))
                nodes.add(int(self.ij[e, 1]))
            self.log.log(
                "summary",
                layer=f"L{k}",
                edges=int(lay.mask.sum()),
                nodes=len(nodes),
                visits=int(lay.visits),
                success=lay.success,
                total_reward=lay.total_reward,
                avg_reward=lay.total_reward / (1.0 + lay.visits),
                ema_residual=lay.ema_residual,
            )


def use_fused(fused: str, device, checkpoint: str | None) -> bool:
    """The engine rule of methods 3 and 4 (the JAX package's, with the
    card as its accelerator): the fused engine when ``fused`` is "on",
    when it is "auto" and the device is CUDA, and whenever a checkpoint
    is given (only the fused engine checkpoints); else the host engine."""
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be auto, on or off, not {fused!r}")
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    return fused == "on" or (fused == "auto" and cuda) \
        or checkpoint is not None


def make_manager(graph, cfg: RunConfig, logger,
                 device: str | torch.device | None = "cuda",
                 fused: str = "auto", checkpoint: str | None = None):
    """The method-3 engine (see :func:`use_fused`): the host-driven
    manager or the fused one (``layering_fused.py``).  ``checkpoint``
    makes the fused engine resumable at its chunk boundaries."""
    if use_fused(fused, device, checkpoint):
        from slam_tpu_torch.methods.layering_fused import \
            FusedLayeringManager
        return FusedLayeringManager(graph, cfg.layering, cfg.solver, logger,
                                    device, checkpoint_path=checkpoint)
    return LayeringManager(graph, cfg.layering, cfg.solver, logger, device)


def load_for_manager(cfg: RunConfig, logger: RunLogger) -> PoseGraph:
    """The graph of a method-3/4 run, outliers injected and initialised,
    with ``init_nodes.txt`` and ``init_edges.txt`` written."""
    from slam_tpu_torch.solver.init import apply_init

    runtime.require_type(cfg, RunConfig, "cfg")
    graph = g2o.load_g2o(g2o.find_dataset(cfg.dataset))
    graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
    graph = apply_init(graph, cfg, logger)
    g2o.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"),
                    graph.poses)
    g2o.write_edges(os.path.join(cfg.save_path, "init_edges.txt"), graph)
    return graph


def plots_available(logger: RunLogger) -> bool:
    """Whether matplotlib is installed for the run's plots; logs a
    ``[plot]`` line when it is not (the other artifacts are written
    all the same)."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is not None:
        return True
    logger.log("plot", msg="skipped: matplotlib is not installed")
    return False


def log_engine(logger: RunLogger, mgr, wall: float) -> None:
    """The ``[engine]`` record of a run: the engine, its short solves,
    their LM iterations, the fused engine's chunks and the manager's wall
    seconds."""
    chunks = getattr(mgr, "chunks", None)
    logger.log("engine", device=str(mgr.ss.dev),
               linear_solver=mgr.eval_cfg.linear_solver,
               dtype=mgr.eval_cfg.dtype, fused=chunks is not None,
               chunks=0 if chunks is None else chunks,
               short_solves=mgr.ss.solves,
               lm_iterations=mgr.ss.iterations, wall_s=wall)


def run_from_config(cfg: RunConfig,
                    device: str | torch.device | None = "cuda",
                    fused: str = "auto", checkpoint: str | None = None
                    ) -> LayeringOutput:
    """Reference-equivalent method-3 pipeline with ``save/`` artifacts
    (``layer_manager.cpp:546-600``); ``fused`` and ``checkpoint`` pick
    the engine (:func:`make_manager`)."""
    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, "method3.log"))
    try:
        graph = load_for_manager(cfg, logger)
        mgr = make_manager(graph, cfg, logger, device, fused, checkpoint)
        t0 = time.perf_counter()
        out = mgr.run()
        log_engine(logger, mgr, time.perf_counter() - t0)

        with open(os.path.join(cfg.save_path, "layers.txt"), "w") as f:
            for i, k in out.assignments:
                f.write(f"{i} {k}\n")
        g2o.write_nodes(
            os.path.join(cfg.save_path, "opt_nodes_method3.txt"), out.poses
        )
        g2o.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"),
                        out.poses)
        g2o.write_nodes(
            os.path.join(cfg.save_path, "opt_nodes_most_selected.txt"),
            host_poses(out.layers[out.most_selected_layer].poses),
        )

        if plots_available(logger):
            from slam_tpu_torch.viz import plot
            plot.plot_trajectories(
                os.path.join(cfg.save_path, "init_nodes.txt"),
                os.path.join(cfg.save_path, "opt_nodes.txt"),
                os.path.join(cfg.save_path, "plot_best.png"),
            )
            plot.plot_trajectories(
                os.path.join(cfg.save_path, "init_nodes.txt"),
                os.path.join(cfg.save_path, "opt_nodes_most_selected.txt"),
                os.path.join(cfg.save_path, "plot_most_selected.png"),
            )
    finally:
        logger.close()
    return out
