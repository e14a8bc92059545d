"""Chunk loop and eval solver of the fused method-3/4 engines.

Port of ``slam_tpu/methods/_fused_common.py``.  A fused engine keeps its
layer state in device tensors and walks the candidate edges in chunks;
inside a chunk the host enqueues work and reads nothing back, and each
chunk's per-candidate outputs come back to the host in one copy.  The
state and the outputs are checkpointed at every chunk boundary, so a
pre-empted run resumes after its last finished chunk.

Dropped on purpose (TPU workarounds): the adaptive chunk probe, the
deadline and its resizing, the AOT warm-up and ``SLAM_TPU_CHUNK_DEADLINE_S``
(the TPU worker killed single executions past about a minute), and the
chain-compressed incidence of the eval edge set.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.methods.layering import DENSE_MAX_NODES, ShortSolves, \
    eval_solver_config
from slam_tpu_torch.utils.checkpoint import load_checkpoint, \
    save_checkpoint

#: Candidates per chunk when the configuration names none (the JAX
#: package's CPU rule, on every device here).
DEFAULT_CHUNK = 64


def fingerprint(*arrays, extra: str = "") -> str:
    """Cheap content hash tying a checkpoint to (graph, candidates, config)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def to_host(outs: dict) -> dict:
    """A chunk's per-candidate device outputs as host arrays, in one
    device-to-host copy: every field is widened to float64 (exact for the
    float32 values and the small integers and flags), packed side by side,
    copied, and cut apart into its own dtype again."""
    fields = list(outs.items())
    if not fields:
        return {}
    n = fields[0][1].shape[0]
    packed = torch.cat([v.reshape(n, -1).to(torch.float64)
                        for _, v in fields], dim=1).cpu().numpy()
    host, col = {}, 0
    for k, v in fields:
        width = int(np.prod(v.shape[1:], dtype=np.int64))
        a = packed[:, col:col + width].reshape(v.shape)
        col += width
        if v.dtype == torch.bool:
            a = a != 0
        elif not v.dtype.is_floating_point:
            a = a.astype(np.int64)
        host[k] = a
    return host


def _concat(outs: list[dict]) -> dict:
    if len(outs) == 1:
        return outs[0]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def run_chunked(state, chunk_fn, consts, xs: list[np.ndarray], chunk: int,
                cfg, checkpoint_path: str | None = None, fp: str = ""):
    """Run ``chunk_fn(state, consts, xs_chunk, cfg) -> (state, outs)``
    over the candidates ``xs`` (host arrays, one row each) in chunks of
    ``chunk``; the last chunk takes what is left.  Returns
    ``(final state, outs concatenated on the host, chunks run)``.

    With ``checkpoint_path`` the state (``s_*``) and the outputs so far
    (``o_*``) are written at every chunk boundary under the meta
    ``fingerprint``/``done``; a run whose checkpoint carries the same
    fingerprint resumes after its ``done`` candidates."""
    if chunk < 1:
        raise ValueError(f"scan chunk must be >= 1, got {chunk}")
    total = xs[0].shape[0]
    done, outs, chunks = 0, [], 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        saved, meta = load_checkpoint(checkpoint_path)
        if meta.get("fingerprint") == fp and 0 <= meta.get("done", -1) \
                <= total:
            done = int(meta["done"])
            state = type(state)(**{
                k: torch.as_tensor(saved[f"s_{k}"], dtype=v.dtype,
                                   device=v.device)
                for k, v in state._asdict().items()})
            prev = {k[2:]: saved[k] for k in saved if k.startswith("o_")}
            outs = [prev] if done > 0 and prev else []

    while done < total:
        sl = slice(done, min(done + chunk, total))
        state, o = chunk_fn(state, consts, [x[sl] for x in xs], cfg)
        outs.append(to_host(o))
        done = sl.stop
        chunks += 1
        if checkpoint_path:
            merged = _concat(outs)
            save_checkpoint(
                checkpoint_path,
                {**{f"s_{k}": v.cpu().numpy()
                    for k, v in state._asdict().items()},
                 **{f"o_{k}": v for k, v in merged.items()}},
                meta={"fingerprint": fp, "done": done},
            )
            outs = [merged]
    return state, (_concat(outs) if outs else {}), chunks


def setup_eval_solver(graph, cfg, solver: SolverConfig, device,
                      widths: tuple = ()):
    """The fused engines' short solves (methods 3 and 4).  Returns
    ``(ss, scan_chunk)``: the :class:`ShortSolves` of ``graph`` (its
    edge set, gauge, the one plan every eval shares and the stacked plan
    of each batch width in ``widths``) and
    the chunk.  The stacked plans read the host, so every width a chunk
    folds is built here, before the first chunk.

    The eval's linear solver: ``auto``/``schur`` is the exact partitioned
    Schur solve on the card at every graph size (the JAX accelerator rule
    under its default chunking) and, on the CPU, dense up to 2048 nodes
    and PCG above; ``cfg.eval_linear`` (schur, pcg or dense) overrides
    either.  The Schur partition is built once, here, over the graph
    (``batched.schur_plan``).  ``cfg.scan_chunk`` None is
    :data:`DEFAULT_CHUNK` candidates a chunk; a number is taken as given.
    """
    dev = torch.device("cuda" if device is None else device)
    linear = solver.linear_solver
    if linear in ("auto", "schur"):
        if dev.type == "cuda":
            linear = "schur"
        else:
            linear = ("dense" if graph.num_nodes <= DENSE_MAX_NODES
                      else "pcg")
    if cfg.eval_linear in ("schur", "pcg", "dense"):
        linear = cfg.eval_linear
    eval_cfg = eval_solver_config(solver, cfg, graph.num_nodes, linear)
    ss = ShortSolves(graph, eval_cfg, dev, cfg.eval_schur_blocks, widths)
    chunk = DEFAULT_CHUNK if cfg.scan_chunk is None else cfg.scan_chunk
    return ss, chunk
