"""On the card, at each cell's own size: the control (the plain reference
computed in TF32, put in the program's place) comes out not correct, the
program on the same seeds comes out correct, and the program's answer
broken where it is produced comes out not correct: the state returned
unchanged, half of the batch left out (its lanes as they went in), one
lane left out, every lane's poses moved by 0.1 m of noise.  One lane's
poses so moved is read too, and not asserted: under joint switchable
constraints the median passes it and its shortfall is small (PERF.md).
Each reading goes to standard output as one JSON line (``pytest -s``);
the assertions come after every reading is out."""

import json

import pytest
import torch

from portbench import cell as cells
from portbench.cell import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
#: A fault that is read and printed but not asserted.
READ_ONLY = {"one_lane_altered"}


def _noisy(poses, lanes, seed):
    g = torch.Generator().manual_seed(seed)
    out = poses.clone()
    noise = 0.1 * torch.randn(out[:, 1:, :2].shape, generator=g,
                              dtype=out.dtype)
    out[lanes, 1:, :2] += noise[lanes].to(out.device)
    return out


def faults(res, batch, seed) -> dict:
    """The program's answer ``res`` broken in each way, by name."""
    from portbench.readings import Answer

    B = res.poses.shape[0]
    one = seed % B

    def at_start(lanes):
        poses, sw = res.poses.clone(), res.switches.clone()
        poses[lanes] = batch.poses0[lanes]
        sw[lanes] = batch.switches0[lanes]
        return Answer(poses, sw)

    return {"state_unchanged": at_start(list(range(B))),
            "half_batch_left_out": at_start(list(range(B // 2, B))),
            "one_lane_left_out": at_start([one]),
            "answer_altered": Answer(_noisy(res.poses, list(range(B)), seed),
                                     res.switches),
            "one_lane_altered": Answer(_noisy(res.poses, [one], seed),
                                       res.switches)}


def _over(got, limits):
    return [n for n, lim in limits.items() if not got[n] <= lim]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, cuda_device):
    from slam_tpu_torch import runtime

    from portbench import check, generate, program, readings

    runtime.setup_device(cuda_device)
    c = cells.load(cell)
    st = check.settings(c.config, c.traffic)
    verdicts = []
    for seed in SEEDS:
        graphs = generate.graphs(c.config, c.traffic, seed)
        targets = check.reference_targets(graphs, st, cuda_device)
        answers = {"control": readings.control_answer(
            graphs, c.config, c.traffic, cuda_device)}
        prog = program.build(graphs, c.config, c.traffic, cuda_device)
        res = prog.entry()
        answers["program"] = readings.Answer(res.poses, res.switches)
        answers.update(faults(res, prog.batch, seed))
        for kind, answer in answers.items():
            got = readings.lane_readings(answer, graphs, c.config,
                                         c.traffic, cuda_device, targets)
            over = _over(got, c.limits)
            print(json.dumps({"cell": cell, "seed": seed, "kind": kind,
                              "over": over, **got}), flush=True)
            verdicts.append((seed, kind, over))
        del prog, res, answers
        torch.cuda.empty_cache()
    for seed, kind, over in verdicts:
        if kind == "program":
            assert not over, (seed, kind, over)
        elif kind not in READ_ONLY:
            assert over, (seed, kind, over)
