"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (the CPU, the plain kernel
versions) and drives the rest of a run of ``intel50.sc.b8_dense`` (two
lanes, 3 LM iterations a request), with the request replaced by one that
breaks the answer where it is produced: the solve returns its start
unchanged; half of the batch is left out (its lanes come back as they
went in); one lane is left out; the answer is altered (every lane's
poses moved by 0.1 m of noise).  A sound run of the same size comes out
correct.  The same faults at each cell's own size are read on the card
(``test_portbench_control.py``).  Every cell runs on one chip: none has
an exchange between chips to leave out.
"""

import pytest
import torch

from portbench import run as bench_run

SIZE = {"lanes": 2, "lm_iters": 3}


def _unchanged(entry, prog):
    def broken():
        res = entry()
        return res._replace(poses=prog.batch.poses0.clone(),
                            switches=prog.batch.switches0.clone())
    return broken


def _half_left_out(entry, prog):
    def broken():
        res = entry()
        poses = res.poses.clone()
        half = poses.shape[0] // 2
        poses[half:] = prog.batch.poses0[half:]
        return res._replace(poses=poses)
    return broken


def _one_lane_left_out(entry, prog):
    def broken():
        res = entry()
        poses = res.poses.clone()
        poses[-1] = prog.batch.poses0[-1]
        return res._replace(poses=poses)
    return broken


def _answer_altered(entry, prog):
    def broken():
        res = entry()
        poses = res.poses.clone()
        g = torch.Generator().manual_seed(0)
        poses[:, 1:, :2] += 0.1 * torch.randn(
            poses[:, 1:, :2].shape, generator=g, dtype=poses.dtype)
        return res._replace(poses=poses)
    return broken


def _run(wrap):
    torch.set_num_threads(2)
    return bench_run.run("intel50.sc.b8_dense", 2**33 + 1, 0.1, False,
                         device="cpu", overrides=SIZE, wrap_entry=wrap,
                         log=lambda *a, **k: None)


def test_sound_run_is_correct():
    out = _run(None)
    assert out["correct"] is True
    assert set(out["check"]) == {"median_lane_excess", "lane_shortfall"}
    for n in out["check"].values():
        assert n["value"] <= n["limit"]


@pytest.mark.parametrize("wrap", [_unchanged, _half_left_out,
                                  _one_lane_left_out, _answer_altered],
                         ids=["state_unchanged", "half_batch_left_out",
                              "one_lane_left_out", "answer_altered"])
def test_broken_run_is_not_correct(wrap):
    out = _run(wrap)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
