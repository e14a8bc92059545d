"""Every BlockSystem field of the port's linearisation against the JAX
package's (XLA path, float64 on the CPU), on the circle fixture with
outliers and on the INTEL+50 replay graph: 1e-10 relative.  Then the fused
kernel's indexed entry, which the solver calls: bitwise the JAX-shaped
entry on gathered inputs and the former gathered path, against the JAX
Pallas kernel in interpret mode, the loop mask it reads from the
EdgeSet, and the checks its wrapper makes before a launch."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.io import g2o
from slam_tpu.ops import pallas_linearize as jlin
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import problem as jp
from slam_tpu.solver.models import SE2Model as JaxSE2
from slam_tpu_torch import convert, ops
from slam_tpu_torch.ops import linearize as olin
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import problem as tp
from slam_tpu_torch.solver.models import SE2Model as TorchSE2

REPLAY = os.path.join(os.path.dirname(__file__), "..", "results", "replay",
                      "INTEL_50out_seed42.g2o")
KW = dict(dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)


def _rel_close(t, j, err_msg=""):
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(np.asarray(t), j, rtol=1e-10,
                               atol=1e-10 * scale, err_msg=err_msg)


def _both(graph, pad_to):
    g = graph.canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float64, pad_to=pad_to)
    jf = jp.anchor_first_node(g.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(g.num_nodes)
    rng = np.random.default_rng(3)
    # Perturbed poses so every robust branch is exercised.
    poses = g.poses + rng.normal(scale=0.05, size=g.poses.shape)
    sw = rng.uniform(0.2, 1.0, size=je.num_edges)
    return g, je, te, jf, tf, poses, sw


@pytest.fixture(scope="module")
def circle_case(circle_outliers):
    return _both(circle_outliers[0], pad_to=256)


@pytest.fixture(scope="module")
def intel_case():
    return _both(g2o.load_g2o(REPLAY), pad_to=1536)


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs", "sc", "sc_varpro"])
def test_block_system_matches(request, case, robust):
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    js = jl.linearize(jnp.asarray(poses), jnp.asarray(sw), je, jf,
                      model=JaxSE2, robust=robust, **KW)
    ts = tl.linearize(torch.as_tensor(poses), torch.as_tensor(sw), te, tf,
                      model=TorchSE2, robust=robust, **KW)
    assert ts._fields == js._fields
    for name in js._fields:
        _rel_close(getattr(ts, name), getattr(js, name), err_msg=name)


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs", "sc", "sc_varpro"])
def test_cost_only_matches(request, case, robust):
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    j = jl.cost_only(jnp.asarray(poses), jnp.asarray(sw), je, model=JaxSE2,
                     robust=robust, **KW)
    t = tl.cost_only(torch.as_tensor(poses), torch.as_tensor(sw), te,
                     model=TorchSE2, robust=robust, **KW)
    _rel_close(t, j)


def test_loop_psi_matches(intel_case):
    g, je, te, jf, tf, poses, sw = intel_case
    _rel_close(tl.loop_psi(torch.as_tensor(poses), te, TorchSE2, 0.5),
               jl.loop_psi(jnp.asarray(poses), je, JaxSE2, 0.5))
    _rel_close(tl.loop_psi_mean(torch.as_tensor(poses), te, TorchSE2, 0.5),
               jl.loop_psi_mean(jnp.asarray(poses), je, JaxSE2, 0.5))


def test_edge_set_from_jax_matches_native_build(intel_case):
    g, je, te, jf, tf, poses, sw = intel_case
    conv = convert.edge_set_from_jax(je, g.num_nodes)
    for name in ("ij", "meas", "is_loop", "active", "info"):
        assert torch.equal(getattr(conv, name), getattr(te, name)), name
    for plan in ("plan_a", "plan_b"):
        for a, b in zip(getattr(conv, plan), getattr(te, plan)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
    free = convert.free_mask_from_jax(jf)
    assert torch.equal(free.node, tf.node)


def test_window_and_anchor_masks_match(intel_case):
    g, je, te, jf, tf, poses, sw = intel_case
    _rel_close(tp.window_mask(te, 100, 400), jp.window_mask(je, 100, 400))
    _rel_close(tp.anchor_node(g.num_nodes, 7).node,
               jp.anchor_node(g.num_nodes, jnp.int32(7)).node)


# The fused kernel's indexed entry (the solver's path), on the CPU where
# each entry takes its plain version.

def _gathered_args(te, poses, free):
    """The JAX kernel's inputs: endpoints gathered with index_select."""
    E = te.num_edges
    pa, pb = poses.index_select(0, te.ab.long()).split(E)
    fa, fb = free.node.index_select(0, te.ab.long()).split(E)
    return (pa, pb, te.meas, fa, fb, te.is_loop.to(poses.dtype), te.active)


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_indexed_linearize_plain_equals_gathered(request, case, robust):
    """The indexed entry's plain version, and the wrapper on CPU tensors,
    are bitwise the JAX-shaped plain version on gathered inputs."""
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    P = torch.as_tensor(poses)
    want = olin.fused_linearize_se2_plain(*_gathered_args(te, P, tf), 0.5,
                                          0.01, robust=robust)
    plain = olin.fused_linearize_se2_indexed_plain(
        P, tf.node, te.ab, te.meas, te.loop_f, te.active, 0.5, 0.01,
        robust=robust)
    wrapper = olin.fused_linearize_se2_indexed(P, tf.node, te, 0.5, 0.01,
                                               robust=robust)
    assert set(plain) == set(wrapper) == set(want)
    for k in want:
        assert torch.equal(plain[k], want[k]), k
        assert torch.equal(wrapper[k], want[k]), k


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_indexed_linearize_matches_pallas_interpret(request, case, robust):
    """Against the JAX Pallas kernel in interpret mode: 1e-12 relative on
    what the TPU kernel's asin polynomial does not reach (e[:2] and the
    first two rows of Ja, Jb), 1e-8 on every output (that polynomial's own
    error, about 3e-9 in e[2])."""
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    P = torch.as_tensor(poses)
    t = olin.fused_linearize_se2_indexed(P, tf.node, te, 0.5, 0.01,
                                         robust=robust)
    j = jlin.fused_linearize_se2(
        *(jnp.asarray(x.numpy()) for x in _gathered_args(te, P, tf)), 0.5,
        0.01, robust=robust, interpret=True)
    assert set(t) == set(j)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0,
                                   atol=1e-8, err_msg=k)
    for k, sl in (("e", np.s_[:, :2]), ("Ja", np.s_[:, :2]),
                  ("Jb", np.s_[:, :2])):
        _rel_close_at(t[k].numpy()[sl], np.asarray(j[k])[sl], 1e-12, k)


def _rel_close_at(t, j, rel, err_msg):
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("case", ["circle_case", "intel_case"])
@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_linearize_bitwise_as_gathered_path(request, case, robust):
    """``linearize`` through the indexed entry gives bit for bit the
    BlockSystem of the former path: both endpoints gathered, the
    JAX-shaped fused call, the node sums, the gauge identity."""
    g, je, te, jf, tf, poses, sw = request.getfixturevalue(case)
    P = torch.as_tensor(poses)
    got = tl.linearize(P, torch.as_tensor(sw), te, tf, model=TorchSE2,
                       robust=robust, **KW)
    pa, pb = te.gather_ab(P)
    fa, fb = te.gather_ab(tf.node)
    out = olin.fused_linearize_se2(pa, pb, te.meas, fa, fb,
                                   te.is_loop.to(P.dtype), te.active,
                                   KW["dcs_phi"], KW["huber_delta"],
                                   robust=robust)
    Hdiag, grad = te.node_sums((out["Haa"], out["Hbb"]),
                               (out["ga"], out["gb"]))
    want = dict(Hdiag=Hdiag + tl._fixed_identity(tf, 3, 1.0),
                Hoff=out["Hoff"], g=grad, cost=0.5 * torch.sum(out["rho"]),
                Ja=out["Ja"], Jb=out["Jb"], r=out["e"], w=out["w"])
    for name, val in want.items():
        assert torch.equal(getattr(got, name), val), name


def test_edge_prep_is_per_edge_set(intel_case):
    """The float loop mask is made with the EdgeSet, in the dtype of its
    measurements (``is_loop`` is its boolean view, not a second copy), and
    a call reads the EdgeSet it is given: another active mask or loop mask
    gives that EdgeSet's outputs, and nothing is kept between calls."""
    g, je, te, jf, tf, poses, sw = intel_case
    assert te.loop_f.dtype == te.meas.dtype == torch.float64
    assert torch.equal(te.loop_f, te.is_loop.to(torch.float64))
    te32 = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                  dtype=torch.float32, pad_to=1536)
    assert te32.loop_f.dtype == torch.float32
    assert torch.equal(te32.is_loop, te.is_loop)
    with pytest.raises(ValueError):
        te._replace(is_loop=~te.is_loop)
    P = torch.as_tensor(poses)

    def lin(edges):
        return olin.fused_linearize_se2_indexed(P, tf.node, edges, 0.5, 0.01,
                                                robust="dcs")

    full = lin(te)
    half = te._replace(active=te.active * 0.5)
    assert torch.equal(lin(half)["w"], 0.5 * full["w"])
    flipped = te._replace(loop_f=1.0 - te.loop_f)
    assert torch.equal(flipped.is_loop, ~te.is_loop)
    got = lin(flipped)
    want = olin.fused_linearize_se2_plain(*_gathered_args(flipped, P, tf),
                                          0.5, 0.01, robust="dcs")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["e"], full["e"])
    again = lin(te)
    for k in full:
        assert torch.equal(again[k], full[k]), k


def _meta(te, **swap):
    """``te`` with its edge tensors on the meta device (no data, no
    launch), some fields swapped first."""
    te = te._replace(**swap)
    return te._replace(**{k: getattr(te, k).to("meta") for k in
                          ("ij", "meas", "loop_f", "active", "info", "ab")})


def test_indexed_wrapper_checks_before_any_launch(intel_case):
    """Off the CPU, bad shapes, dtypes and layouts raise before the kernel
    is built or launched: of the poses, the free mask and every edge tensor
    the kernel reads, on each call."""
    g, je, te, jf, tf, poses, sw = intel_case
    N = g.num_nodes
    before = ops.launch_counts()
    good = _meta(te)
    poses_m = torch.empty((N, 3), dtype=torch.float64, device="meta")
    free_m = torch.empty((N,), dtype=torch.float64, device="meta")
    bad_calls = [
        (torch.empty((N + 1, 3), dtype=torch.float64, device="meta"), free_m,
         good),
        (poses_m.float(), free_m.float(), good),  # edges are float64
        (poses_m, torch.empty((N - 1,), dtype=torch.float64, device="meta"),
         good),
        (poses_m, free_m.float(), good),
        (poses_m, free_m, _meta(te, ab=te.ab.long())),
        (poses_m, free_m, _meta(te, ab=te.ab[1:])),
        (poses_m, free_m, _meta(te, active=te.active[1:])),
        (poses_m, free_m, _meta(te, meas=te.meas[:, :2])),
        (poses_m, free_m, _meta(te, loop_f=te.loop_f[1:])),
        (poses_m, free_m, _meta(te, loop_f=te.loop_f.float())),
        (poses_m, free_m, _meta(te, meas=te.meas.t().contiguous().t())),
    ]
    for k, (P, F, edges) in enumerate(bad_calls):
        with pytest.raises(ValueError):
            olin.fused_linearize_se2_indexed(P, F, edges, 0.5, 0.01,
                                             robust="dcs")
            pytest.fail(f"bad call {k} did not raise")
    with pytest.raises(ValueError):
        olin.fused_linearize_se2_indexed(poses_m, free_m, good, 0.5, 0.01,
                                         robust="sc")
    E = te.num_edges
    meta = [torch.empty(s, dtype=torch.float64, device="meta") for s in
            ((E, 3), (E, 3), (E, 3), (E,), (E,), (E,), (E,))]
    for k in range(7):
        bad = list(meta)
        bad[k] = bad[k].float()
        with pytest.raises(ValueError):
            olin.fused_linearize_se2(*bad, 0.5, 0.01)
        bad[k] = meta[k][:-1]
        with pytest.raises(ValueError):
            olin.fused_linearize_se2(*bad, 0.5, 0.01)
    assert ops.launch_counts() == before


def test_outputs_are_views_of_one_field_major_buffer():
    """The ten outputs of a launch: contiguous views of one buffer, field
    after field in the kernel's order, 56 values per edge."""
    E = 7
    out = olin._outputs(E, torch.float64, torch.device("cpu"))
    assert list(out) == [name for name, _ in olin._FIELDS]
    base = out["e"].untyped_storage().data_ptr()
    offset = 0
    for (name, shape), t in zip(olin._FIELDS, out.values()):
        assert tuple(t.shape) == (E, *shape) and t.is_contiguous(), name
        assert t.untyped_storage().data_ptr() == base, name
        assert t.storage_offset() == offset, name
        offset += t.numel()
    assert offset == 56 * E == out["e"].untyped_storage().nbytes() // 8
