"""The port's grouped gather and segment sum on the CPU, where each wrapper
takes its plain PyTorch version: against the JAX package's Pallas kernels
in interpret mode group by group, against the same groups one at a time,
on edge cases of the plan, on block-grid placement, and the launches of
one LM iteration of INTEL+50 (float32 and float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import pallas_gather as jgather
from slam_tpu_torch.ops import gather as tgather
from slam_tpu_torch.tools import kernel_times

DTYPES = [torch.float32, torch.float64]
# Against the JAX kernel: both add a segment's rows one after another from
# zero, in source order, so they agree to rounding of the type.
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}


def _grid(blocks, lead, rows, cols, D):
    """The flat (..., rows, cols, D, D) block result as the row-major
    (..., rows*D, cols*D) matrix (the permuting copy the plans replace)."""
    g = blocks.reshape(*lead, rows, cols, D, D)
    nd = len(lead)
    g = g.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return g.reshape(*lead, rows * D, cols * D)


def _groups(rng, count, dtype):
    """``count`` random (values, plan, idx, src) groups of varied widths,
    some with empty segments, repeated sources and trailing dims."""
    out = []
    for g in range(count):
        n = int(rng.integers(1, 40))
        M = int(rng.integers(0, 120))
        width = (1, 3, 9, (3, 3))[g % 4]
        shape = (M + 5,) + ((width,) if isinstance(width, int) else width)
        v = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
        idx = rng.integers(0, n, size=M)
        src = rng.integers(0, M + 5, size=M)
        out.append((v, tgather.segment_plan(idx, n, src=src), idx, src))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_gather_matches_pallas_interpret(dtype):
    """One gather of concatenated index sets is each set's gather, as the
    JAX kernel and a gather of that set alone give it."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 3))
    sets = [rng.integers(0, 300, size=k).astype(np.int32)
            for k in (1100, 1, 37)]
    xt = torch.as_tensor(x, dtype=dtype)
    both = tgather.gather_rows(xt, torch.as_tensor(np.concatenate(sets)))
    at = 0
    for idx in sets:
        part = both[at:at + idx.size]
        at += idx.size
        alone = tgather.gather_rows(xt, torch.as_tensor(idx))
        assert torch.equal(part, alone)
        j = jgather.gather_rows(jnp.asarray(xt.numpy()), jnp.asarray(idx),
                                interpret=True)
        np.testing.assert_array_equal(part.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("count", list(range(1, tgather.MAX_GROUPS + 1)))
def test_grouped_scatter_matches_pallas_interpret(dtype, count):
    rng = np.random.default_rng(10 + count)
    groups = _groups(rng, count, dtype)
    sums = tgather.scatter_add_groups([(v, p) for v, p, _, _ in groups])
    assert len(sums) == count
    for (v, plan, idx, src), got in zip(groups, sums):
        assert torch.equal(got, tgather.scatter_add_rows(v, plan))
        assert got.shape == (plan.n,) + tuple(v.shape[1:])
        vf = v.reshape(v.shape[0], -1)[torch.as_tensor(src, dtype=torch.long)]
        j = np.asarray(jgather.scatter_add_rows(
            jnp.asarray(vf.numpy()), jnp.asarray(idx, jnp.int32), plan.n,
            interpret=True))
        scale = max(1.0, np.abs(j).max(initial=0.0))
        np.testing.assert_allclose(got.reshape(plan.n, -1).numpy(), j,
                                   rtol=0, atol=TOL[dtype] * scale)


def test_scatter_groups_limit():
    v = torch.ones((3, 1))
    plan = tgather.segment_plan([0, 1, 1], 2)
    with pytest.raises(ValueError):
        tgather.scatter_add_groups([(v, plan)] * (tgather.MAX_GROUPS + 1))
    assert tgather.scatter_add_groups([]) == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_edge_cases(dtype):
    """Empty and one-row segments, a repeated source row, a plan with no
    rows; the work list holds the non-empty segments only where most are
    empty, and every segment where at least half are non-empty."""
    v = torch.as_tensor(np.arange(12.0).reshape(6, 2), dtype=dtype)
    plan = tgather.segment_plan([4, 1, 4, 4, 6], 8, src=[2, 5, 2, 0, 3])
    assert plan.seg.tolist() == [1, 4, 6]
    assert plan.starts.tolist() == [0, 1, 4, 5]
    assert plan.perm.tolist() == [5, 2, 2, 0, 3]
    assert all(t.dtype == torch.int32 for t in
               (plan.src, plan.idx, plan.perm, plan.offsets, plan.seg,
                plan.starts))
    want = torch.zeros((8, 2), dtype=dtype)
    want[1] = v[5]
    want[4] = v[2] + v[2] + v[0]
    want[6] = v[3]
    assert torch.equal(tgather.scatter_add_rows(v, plan), want)

    dense = tgather.segment_plan([4, 1, 4, 4, 2], 6, src=[2, 5, 2, 0, 3])
    assert dense.seg.tolist() == list(range(6))
    assert dense.starts.tolist() == dense.offsets.tolist()
    want = torch.zeros((6, 2), dtype=dtype)
    want[1] = v[5]
    want[2] = v[3]
    want[4] = v[2] + v[2] + v[0]
    assert torch.equal(tgather.scatter_add_rows(v, dense), want)

    empty = tgather.segment_plan(np.zeros(0, np.int64), 5)
    assert empty.seg.numel() == 0 and empty.starts.tolist() == [0]
    assert empty.src_rows == 0
    out = tgather.scatter_add_rows(v, empty)
    assert out.shape == (5, 2) and not out.any()
    with pytest.raises(ValueError):
        tgather.scatter_add_rows(v[:3], plan)  # the plan reads row 5
    with pytest.raises(ValueError):
        tgather.segment_plan([0, 1], 2, src=[0, -1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_block_grid_equals_flat_through_grid(dtype, lead):
    """A block-grid plan gives the flat plan's result through the old
    permuting copy, to the bit, including its empty blocks."""
    rng = np.random.default_rng(len(lead))
    rows, cols, D = 5, 7, 3
    n = int(np.prod(lead, dtype=np.int64)) * rows * cols
    M = 60
    idx = rng.integers(0, n, size=M)
    src = rng.integers(0, 40, size=M)
    v = torch.as_tensor(rng.normal(size=(40, D * D)), dtype=dtype)
    flat = tgather.segment_plan(idx, n, src=src)
    grid = tgather.segment_plan(idx, n, src=src, grid=(lead, rows, cols))
    want = _grid(tgather.scatter_add_rows(v, flat), lead, rows, cols, D)
    got = tgather.scatter_add_rows(v, grid)
    assert got.shape == (*lead, rows * D, cols * D)
    assert torch.equal(got, want)
    a, b = tgather.scatter_add_groups([(v, grid), (v, flat)])
    assert torch.equal(a, want) and torch.equal(b, tgather.scatter_add_rows(
        v, flat))
    with pytest.raises(ValueError):
        tgather.scatter_add_rows(v[:, :8], grid)  # 8 values: not D*D
    with pytest.raises(ValueError):
        tgather.segment_plan(idx, n, src=src, grid=(lead, rows, cols + 1))


def test_placement_offsets_pass_int32():
    """A built (never allocated) grid of 65,536 x 65,536 elements: the
    offsets of its last blocks lie beyond 2**31 and are exact in int64."""
    rows = cols = 1024
    D = 64
    plan = tgather.segment_plan([rows * cols - 1, 5, cols], rows * cols,
                                grid=((), rows, cols))
    off = tgather.placement(plan, D * D)
    assert off.dtype == torch.int64 and off.shape == (3, D * D)
    i, j = np.divmod(np.arange(D * D), D)
    for q, s in enumerate(plan.seg.tolist()):
        br, bc = divmod(s, cols)
        want = np.ravel_multi_index((br * D + i, bc * D + j),
                                    (rows * D, cols * D))
        np.testing.assert_array_equal(off[q].numpy(), want)
    assert int(off.max()) == (rows * D) ** 2 - 1 > 2**31


@pytest.fixture(scope="module")
def intel_problem():
    from slam_tpu_torch.tools.problems import intel50_plain_dcs

    return intel50_plain_dcs("cpu", "float64")


def test_lm_iteration_launch_calls(intel_problem):
    """One native LM iteration of INTEL+50 plain DCS makes at most 6
    gather calls and at most 4 scatter calls (each one kernel launch on
    the card)."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    p = intel_problem
    args = (p.poses0, p.switches0, p.edges, p.free)

    def calls(iters):
        recorded = kernel_times.record(
            lambda: lm_fixed_iters(*args, p.scfg, iters,
                                   partition=p.partition))
        names = [name for name, _, _ in recorded]
        return (names.count("gather_rows"),
                names.count("scatter_add_rows")
                + names.count("scatter_add_groups"))

    (g1, s1), (g2, s2) = calls(1), calls(2)
    assert g2 - g1 <= 6 and s2 - s1 <= 4
    assert (g2 - g1, s2 - s1) == (5, 4)
