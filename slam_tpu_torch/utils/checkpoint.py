"""Solver-state checkpoint / resume.

Port of ``slam_tpu/utils/checkpoint.py``.  ``save_checkpoint``,
``load_checkpoint`` and ``lm_state_dict`` are copies (NumPy only, the same
npz-plus-JSON-meta layout); only the imports differ.  The port imports
nothing of ``slam_tpu``.

The reference has no mid-solve persistence -- only terminal text dumps
(SURVEY §5).  Here the whole optimizer state is small (poses, switches,
lambda, iteration counters), so checkpointing is a single compressed-npz
write, and a pre-empted run resumes from its last snapshot exactly where
it stopped.
"""

from __future__ import annotations

import json
import os

import numpy as np


_META_KEY = "__meta__"


def save_checkpoint(path: str, state: dict, meta: dict | None = None) -> str:
    """Write a state dict of arrays (+ JSON-serialisable meta) atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in state.items()}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Read back ``(state, meta)``."""
    with np.load(path) as z:
        state = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY]).decode()) if _META_KEY in z.files else {}
    return state, meta


def lm_state_dict(poses, switches, lam, iteration, cost, nu=2.0) -> dict:
    """Canonical LM solver state (poses, switches, lambda, nu, iter, cost)
    -- everything needed to resume ``lm_solve`` mid-run."""
    return {
        "poses": np.asarray(poses),
        "switches": np.asarray(switches),
        "lam": np.asarray(lam),
        "nu": np.asarray(nu),
        "iteration": np.asarray(iteration),
        "cost": np.asarray(cost),
    }


class CheckpointingSolver:
    """Drives ``lm_fixed_iters`` in chunks with periodic checkpoints.

    Between chunks the host reads lambda, nu and the cost once and writes
    the state; ``lam0``/``nu0``/``it0`` carry one LM trajectory across
    chunks and restarts, so a chunked run equals one unbroken call.
    """

    def __init__(self, path: str, chunk_iters: int = 10):
        self.path = path
        self.chunk_iters = chunk_iters

    def run(self, poses0, switches0, edges, free, cfg, total_iters,
            model=None, resume: bool = True):
        """``(poses, switches, result)``; ``result`` is None when a resume
        finds the run complete (no chunk left to run)."""
        import torch

        from slam_tpu_torch.solver.lm import lm_fixed_iters

        poses, switches = poses0, switches0
        start = 0
        lam = float(cfg.init_lambda)
        nu = 2.0
        if resume and os.path.exists(self.path):
            state, meta = load_checkpoint(self.path)
            if meta.get("total_iters") == total_iters:
                kw = dict(dtype=poses0.dtype, device=poses0.device)
                poses = torch.as_tensor(state["poses"], **kw)
                switches = torch.as_tensor(state["switches"], **kw)
                start = int(state["iteration"])
                # Older checkpoints stored lam=0.0 (chunked runs then
                # restarted the trust region); treat 0 as "use init".
                lam = float(state.get("lam", 0.0)) or float(cfg.init_lambda)
                nu = float(state.get("nu", 2.0))

        it = start
        res = None
        while it < total_iters:
            n = min(self.chunk_iters, total_iters - it)
            # it0 goes in as a Python int: lm_fixed_iters takes it as the
            # host's iteration count (the GNC anneal position).
            res = lm_fixed_iters(poses, switches, edges, free, cfg, n,
                                 model=model, lam0=lam, it0=it, nu0=nu)
            poses, switches = res.poses, res.switches
            lam = float(res.final_lambda)
            nu = float(res.final_nu)
            it += n
            save_checkpoint(
                self.path,
                lm_state_dict(poses.cpu().numpy(), switches.cpu().numpy(),
                              lam, it, float(res.cost), nu=nu),
                meta={"total_iters": total_iters},
            )
        return poses, switches, res
