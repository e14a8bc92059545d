"""The readings that a cell's limits are set from, on the card, in one
process.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6]

For each of ``--seeds``: the cell's set-up at its own size, one request
of its timed path, and the check's numbers against the plain reference
(the lower readings).  For each of ``--control-seeds``: the control, the
plain reference computed in TF32 (the next precision below the float32
that the configurations state, whose program pins TF32 off) put in the
program's place, judged by the same check (the upper readings).  One JSON
line each.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import torch


class Answer(NamedTuple):
    poses: torch.Tensor      # (B, N, 3)
    switches: torch.Tensor   # (B, E)


def control_answer(graphs, config, traffic, device) -> Answer:
    """The plain reference in TF32, every lane, as one answer."""
    from portbench import check
    from portbench.reference import lm as ref

    res = ref.solve(check.lanes(graphs), check.settings(config, traffic),
                    device, tf32=True)
    return Answer(torch.stack([r.poses for r in res]),
                  torch.stack([r.switches for r in res]))


def lane_readings(answer, graphs, config, traffic, device,
                  targets=None) -> dict:
    """The check's numbers of ``answer``, with each lane's excess and
    shortfall and the reference's objectives."""
    from portbench import check

    st = check.settings(config, traffic)
    if targets is None:
        targets = check.reference_targets(graphs, st, device)
    costs = check.lane_costs(answer, graphs, st)
    return {**check.numbers(costs, targets),
            "lane_excesses": check.lane_excesses(costs, targets),
            "lane_shortfalls": check.lane_shortfalls(costs, targets),
            "reference_costs": [t.cost for t in targets],
            "start_costs": [t.cost0 for t in targets]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--dtype", default=None,
                    help="run the program in this dtype instead (a witness)")
    ap.add_argument("--perturb", action="store_true",
                    help="also run the program from its start poses moved "
                    "by one ulp")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from slam_tpu_torch import runtime

    from portbench import cell as cells
    from portbench import check, generate, program

    dev = runtime.setup_device("cuda")
    c = cells.load(args.workload)
    if args.dtype:
        c = c._replace(config=dict(c.config, dtype=args.dtype))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for kind, seed in [("program", s) for s in seeds] + \
            [("control", s) for s in controls]:
        t0 = time.perf_counter()
        graphs = generate.graphs(c.config, c.traffic, seed)
        extra = {}
        if kind == "program":
            prog = program.build(graphs, c.config, c.traffic, dev)
            res = prog.entry()
            answer = Answer(res.poses, res.switches)
            extra["accepted"] = res.accepted.tolist()
            if args.perturb:
                from slam_tpu_torch.solver.batch import lm_fixed_iters_batch

                p0 = prog.batch.poses0
                moved = torch.nextafter(p0, torch.full_like(p0, 1e30))
                r2 = lm_fixed_iters_batch(moved, *prog.batch.args[1:],
                                          prog.cfg, c.traffic["lm_iters"],
                                          prog.plan)
                perturbed = Answer(r2.poses, r2.switches)
            del prog, res
        else:
            answer = control_answer(graphs, c.config, c.traffic, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = lane_readings(answer, graphs, c.config, c.traffic, dev)
        if kind == "program" and args.perturb:
            targets = [check.Target(a, b) for a, b in zip(
                out["reference_costs"], out["start_costs"])]
            extra["perturbed"] = lane_readings(
                perturbed, graphs, c.config, c.traffic, dev,
                targets)["lane_excesses"]
        out.update(extra)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "answer_s": t1 - t0,
                          "check_s": time.perf_counter() - t1, **out}),
              flush=True)
        del answer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
