"""The system under test: ``slam_tpu_torch``'s seed batch, built through
its public entry points, and what a traced run wraps around it.

Nothing of the program is edited.  In a traced run only, :func:`spans`
wraps the names ``linearize`` and ``_solve_linear`` of
``slam_tpu_torch.solver.lm`` in ``torch.profiler.record_function`` ranges,
and :func:`kernel_calls` records every call of a hand-written kernel's
wrapper inside a range of its own; both put the originals back afterwards.
If the program renames those entries, the metrics that read them find
nothing and stay out of the result.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, NamedTuple

import torch

#: The LM loop's calls that the per-layer spans wrap: name in
#: ``slam_tpu_torch.solver.lm`` -> span name.
SPANS = {"linearize": "linearize", "_solve_linear": "linear_solve"}
#: The range around each hand-written kernel wrapper's call.
KERNEL_SPAN = "hand_written_kernel"
#: The wrappers that launch the hand-written kernels: module -> names.
WRAPPERS = {"slam_tpu_torch.ops.gather": ("gather_rows",
                                          "scatter_add_groups"),
            "slam_tpu_torch.ops.linearize": ("fused_linearize_se2_indexed",),
            "slam_tpu_torch.ops.chol": ("micro_chol_inv",)}


class Program(NamedTuple):
    entry: Callable       # one request: the whole solve, not synchronised
    batch: object         # solver.batch.SeedBatch
    plan: object          # the linear solver's plan
    cfg: object           # SolverConfig
    factors: list         # [(order, count)] of the Cholesky factors an
                          # iteration needs


def build(graphs, config: dict, traffic: dict, device) -> Program:
    """The seed batch of ``graphs`` and its plan, and the request."""
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.graph import PoseGraph
    from slam_tpu_torch.solver.batch import batch_plan, \
        lm_fixed_iters_batch, seed_batch

    dtype = getattr(torch, config["dtype"])
    solver, robust = traffic["linear_solver"], traffic["robust"]
    blocks = traffic["schur_blocks"]
    pgs = [PoseGraph(poses=g.poses, edges_ij=g.ij, edges_meas=g.meas,
                     edges_info=g.info, edge_type=g.etype) for g in graphs]
    batch = seed_batch(pgs, blocks, dtype=dtype, device=device)
    plan = (batch.partition if solver == "schur" else
            batch_plan(batch.edges, solver, batch.seeds, robust))
    cfg = SolverConfig(robust=robust, linear_solver=solver,
                       dtype=config["dtype"], **config["solver"])
    iters = traffic["lm_iters"]
    B, N, D = batch.poses0.shape
    if solver == "schur":
        factors = [(D * plan.ni_max, plan.num_blocks),
                   (D * plan.ns, plan.seeds)]
    elif solver == "dense":
        E = batch.switches0.shape[1]
        order = D * N + (D * -(-E // D) if robust == "sc" else 0)
        factors = [(order, B)]
    else:
        raise ValueError(f"no factor count for the {solver!r} solver")

    def entry():
        return lm_fixed_iters_batch(*batch.args, cfg, iters, plan)

    return Program(entry, batch, plan, cfg, factors)


def shapes(prog: Program) -> dict:
    """What the run prints about the plan it built."""
    B, N, D = prog.batch.poses0.shape
    out = {"lanes": B, "nodes_per_lane": N,
           "edges_per_lane": prog.batch.switches0.shape[1],
           "pad_shapes": list(prog.batch.pad_shapes),
           "factors": [list(f) for f in prog.factors]}
    return out


@contextlib.contextmanager
def _patched(targets):
    """Set ``(module, attr, value)`` for the block, then restore."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in targets]
    try:
        for m, a, v in targets:
            setattr(m, a, v)
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


@contextlib.contextmanager
def spans():
    """The LM loop's ``linearize`` and ``_solve_linear`` calls inside
    ``record_function`` ranges named by :data:`SPANS`."""
    from slam_tpu_torch.solver import lm

    def ranged(fn, name):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call

    with _patched([(lm, attr, ranged(getattr(lm, attr), name))
                   for attr, name in SPANS.items() if hasattr(lm, attr)]):
        yield


@contextlib.contextmanager
def kernel_calls(calls: list, describe):
    """Every outermost call of a hand-written kernel's wrapper, in every
    loaded module of the program that holds it, inside a
    :data:`KERNEL_SPAN` range; appends ``describe(wrapper name, args)``
    to ``calls``."""
    originals = {}
    for mod_name, names in WRAPPERS.items():
        mod = sys.modules.get(mod_name)
        for n in names:
            if mod is not None and hasattr(mod, n):
                originals[id(getattr(mod, n))] = (n, getattr(mod, n))
    depth = [0]

    def recorder(name, fn):
        def call(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            calls.append(describe(name, args))
            depth[0] += 1
            try:
                with torch.profiler.record_function(KERNEL_SPAN):
                    return fn(*args, **kw)
            finally:
                depth[0] -= 1
        # a wrapper counts its launches on its module's name, which is
        # the stand-in's while the block runs
        call.launches = 0
        return call

    targets = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("slam_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if id(val) in originals:
                targets.append((mod, attr, val,
                                recorder(*originals[id(val)])))
    try:
        with _patched([(m, a, stand_in) for m, a, _, stand_in in targets]):
            yield
    finally:
        for _, _, val, stand_in in targets:
            if hasattr(val, "launches"):
                val.launches += stand_in.launches
