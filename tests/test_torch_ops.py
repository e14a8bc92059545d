"""The port's kernel modules on the CPU, where each wrapper takes its plain
PyTorch version, against the JAX package's Pallas kernels in interpret
mode and against its XLA path (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import pallas_gather as jgather
from slam_tpu.ops import pallas_linearize as jlin
from slam_tpu.solver.linearize import linearize as jax_linearize
from slam_tpu.solver.models import SE2Model
from slam_tpu.solver.problem import EdgeSet as JaxEdgeSet
from slam_tpu.solver.problem import FreeMask as JaxFreeMask
from slam_tpu_torch import ops
from slam_tpu_torch.ops import chol as tchol
from slam_tpu_torch.ops import gather as tgather
from slam_tpu_torch.ops import linearize as tlin

N, E = 300, 1100


@pytest.fixture(scope="module")
def edge_inputs():
    """Random edges of a random graph, including loop, inactive and
    gauge-fixed endpoints."""
    rng = np.random.default_rng(21)
    poses = rng.normal(size=(N, 3)) * np.array([15.0, 15.0, 2.0])
    ij = rng.integers(0, N, size=(E, 2))
    meas = rng.normal(size=(E, 3)) * np.array([2.0, 2.0, 0.5])
    loop = rng.random(E) < 0.4
    active = (rng.random(E) < 0.9).astype(np.float64)
    free = np.ones(N)
    free[[0, 17]] = 0.0
    return dict(poses=poses, ij=ij, meas=meas, loop=loop, active=active,
                free=free)


def _kernel_args(d):
    a, b = d["ij"][:, 0], d["ij"][:, 1]
    return (d["poses"][a], d["poses"][b], d["meas"], d["free"][a],
            d["free"][b], d["loop"].astype(np.float64), d["active"])


@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_fused_linearize_matches_pallas_interpret(edge_inputs, robust):
    args = _kernel_args(edge_inputs)
    j = jlin.fused_linearize_se2(*map(jnp.asarray, args), 0.5, 0.01,
                                 robust=robust, interpret=True)
    t = tlin.fused_linearize_se2(*map(torch.as_tensor, args), 0.5, 0.01,
                                 robust=robust)
    assert set(j) == set(t)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        # 1e-8: the TPU kernel's asin polynomial (~3e-9 in e[2]).
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_fused_linearize_matches_xla_path(edge_inputs, robust):
    """Against the JAX package's unfused path: same math, device asin."""
    d = edge_inputs
    jedges = JaxEdgeSet(
        ij=jnp.asarray(d["ij"], jnp.int32), meas=jnp.asarray(d["meas"]),
        is_loop=jnp.asarray(d["loop"]), active=jnp.asarray(d["active"]),
        info=jnp.zeros((E, 6)))
    sys_ = jax_linearize(jnp.asarray(d["poses"]), jnp.ones(E), jedges,
                         JaxFreeMask(node=jnp.asarray(d["free"])),
                         model=SE2Model, robust=robust, dcs_phi=0.5,
                         huber_delta=0.01, sc_prior_lambda=1.0)
    t = tlin.fused_linearize_se2(*map(torch.as_tensor,
                                      _kernel_args(d)), 0.5, 0.01,
                                 robust=robust)
    for tk, jk in (("Ja", "Ja"), ("Jb", "Jb"), ("e", "r"), ("w", "w"),
                   ("Hoff", "Hoff")):
        np.testing.assert_allclose(t[tk].numpy(), np.asarray(getattr(sys_, jk)),
                                   rtol=0, atol=1e-12, err_msg=tk)
    np.testing.assert_allclose(0.5 * t["rho"].sum().item(),
                               float(sys_.cost), rtol=1e-12)


def test_fused_linearize_rejects_other_modes(edge_inputs):
    args = map(torch.as_tensor, _kernel_args(edge_inputs))
    with pytest.raises(ValueError):
        tlin.fused_linearize_se2(*args, 0.5, 0.01, robust="sc")


@pytest.mark.parametrize("width", [1, 3, 9])
def test_gather_rows_matches_pallas_interpret(edge_inputs, width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(N, width))
    idx = edge_inputs["ij"][:, 1].astype(np.int32)
    j = jgather.gather_rows(jnp.asarray(x), jnp.asarray(idx), interpret=True)
    t = tgather.gather_rows(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("width", [1, 3, 9])
def test_scatter_add_rows_matches_pallas_interpret(edge_inputs, width):
    rng = np.random.default_rng(100 + width)
    v = rng.normal(size=(E, width))
    idx = edge_inputs["ij"][:, 0]
    j = jgather.scatter_add_rows(jnp.asarray(v), jnp.asarray(idx, jnp.int32),
                                 N, interpret=True)
    t = tgather.scatter_add_rows(torch.as_tensor(v),
                                 tgather.segment_plan(idx, N))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12)


def test_scatter_with_sources_and_trailing_dims():
    """``src`` selects (and may repeat) source rows; trailing dims are
    kept."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(50, 3, 3))
    src = rng.integers(0, 50, size=80)
    idx = rng.integers(0, 7, size=80)
    plan = tgather.segment_plan(idx, 7, src=src)
    out = tgather.scatter_add_rows(torch.as_tensor(v), plan)
    want = np.zeros((7, 3, 3))
    np.add.at(want, idx, v[src])
    assert out.shape == (7, 3, 3)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-12)
    assert plan.src_rows == src.max() + 1


def test_segment_plan_is_deterministic_and_stable():
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 40, size=500)
    p1, p2 = tgather.segment_plan(idx, 45), tgather.segment_plan(idx, 45)
    for a, b in zip(p1, p2):
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.int32
            assert torch.equal(a, b)
        else:
            assert a == b
    perm, off = p1.perm.numpy(), p1.offsets.numpy()
    assert off[0] == 0 and off[-1] == idx.size and off.size == 46
    for s in range(45):
        seg = perm[off[s]:off[s + 1]]
        assert (idx[seg] == s).all()
        assert (np.diff(seg) > 0).all()  # stable: source order kept


def test_segment_plan_rejects_bad_ids():
    with pytest.raises(ValueError):
        tgather.segment_plan([0, 3], 3)
    with pytest.raises(ValueError):
        tgather.segment_plan([0, -1], 3)
    with pytest.raises(ValueError):
        tgather.segment_plan([0, 1], 3, src=[0])


def test_cpu_tensors_take_plain_versions_and_count_nothing(edge_inputs):
    ops.reset_launches()
    args = map(torch.as_tensor, _kernel_args(edge_inputs))
    tlin.fused_linearize_se2(*args, 0.5, 0.01, robust="dcs")
    x = torch.ones((N, 3), dtype=torch.float64)
    plan = tgather.segment_plan(edge_inputs["ij"][:, 0], N)
    tgather.scatter_add_rows(tgather.gather_rows(x, plan.idx), plan)
    tchol.micro_chol_inv(torch.eye(4, dtype=torch.float64).expand(3, 4, 4))
    assert ops.launch_counts() == {"gather_rows": 0, "scatter_add_rows": 0,
                                   "fused_linearize_se2": 0,
                                   "micro_chol_inv": 0, "stack_cholesky": 0}
