"""The manager oracle's decision streams that the card's method-3/4 runs
are held to.

Runs the port's copies of ``Method3Oracle`` and ``Method4Oracle``
(``slam_tpu_torch/solver/manager_oracle.py``: NumPy/SciPy, f64, short
Ceres-semantics LM solves) on the CPU, on the graphs the port's CLI builds
(``slam_tpu_torch/tools/manager_streams.cell_graph``) for

  intel50 -- ``INTEL 50 {3,4} --seed 42`` (auto init keeps the dataset
             estimates on INTEL),
  csail50 -- ``CSAIL 50 {3,4} --seed 0`` (auto init: PCM-gated chordal),

and writes each cell's full decision streams, assignments and chosen
layers to ``slam_tpu_torch/data/manager_decisions.json`` (about 70 s for
intel50 and 30 s for csail50).  Imports no JAX.

Usage:
  python scripts/torch_manager_reference.py [intel50] [csail50]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CELLS = {"intel50": ("INTEL", 50, 42), "csail50": ("CSAIL", 50, 0)}


def run_cell(dataset: str, outliers: int, seed: int) -> dict:
    from slam_tpu_torch.config import LayeringConfig, MctsConfig
    from slam_tpu_torch.solver.manager_oracle import Method3Oracle, \
        Method4Oracle
    from slam_tpu_torch.tools.manager_streams import cell_graph, \
        compact_m3, compact_m4

    graph = cell_graph(dataset, outliers, seed)
    cfg3, cfg4 = LayeringConfig(), MctsConfig()
    t0 = time.perf_counter()
    m3 = Method3Oracle(graph, cfg3)
    d3 = m3.run()
    t3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    m4 = Method4Oracle(graph, cfg4)
    d4 = m4.run()
    t4 = time.perf_counter() - t0
    return dict(
        dataset=dataset, outliers=outliers, seed=seed,
        nodes=int(graph.num_nodes), candidates=len(d3),
        m3=dict(tau=cfg3.conflict_tau, layers=len(m3.layers),
                best_layer=f"L{m3.best_layer()}",
                assignments=[list(a) for a in m3.assignments],
                oracle_wall_s=t3, decisions=compact_m3(d3)),
        m4=dict(tau=cfg4.conflict_tau, residual_high=cfg4.residual_high,
                layers=len(m4.layers), best_layer=m4.best_layer(),
                oracle_wall_s=t4, decisions=compact_m4(d4)),
    )


def main(argv=None) -> int:
    from slam_tpu_torch.tools.manager_streams import DECISIONS

    cells = (argv if argv is not None else sys.argv[1:]) or list(CELLS)
    out = {}
    if os.path.exists(DECISIONS):
        with open(DECISIONS) as f:
            out = json.load(f)
    for name in cells:
        out[name] = rec = run_cell(*CELLS[name])
        print(name, {k: rec[k] for k in ("nodes", "candidates")},
              {m: {k: rec[m][k] for k in ("layers", "best_layer",
                                          "oracle_wall_s")}
               for m in ("m3", "m4")}, flush=True)
    with open(DECISIONS, "w") as f:
        json.dump(out, f, separators=(",", ":"))
        f.write("\n")
    print("wrote", DECISIONS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
