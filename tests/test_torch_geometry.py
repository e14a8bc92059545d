"""Parity of the PyTorch port's SE(2) geometry and robust kernels with the
JAX package, float64 on the CPU, random poses from a NumPy seed (1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.geometry import se2 as jse2
from slam_tpu.robust import kernels as jk
from slam_tpu_torch.geometry import se2 as tse2
from slam_tpu_torch.robust import kernels as tk

TOL = 1e-12


def _poses(rng, n):
    p = rng.normal(size=(n, 3)) * np.array([20.0, 20.0, 3.0])
    return p


@pytest.fixture(scope="module")
def edges():
    rng = np.random.default_rng(11)
    n = 257
    pa, pb, meas = _poses(rng, n), _poses(rng, n), _poses(rng, n) * 0.1
    return pa, pb, meas


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=tol)


def test_residual_and_jacobians_match(edges):
    pa, pb, meas = edges
    je, jja, jjb = jse2.residual_and_jacobians(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(meas))
    te, tja, tjb = tse2.residual_and_jacobians(
        torch.as_tensor(pa), torch.as_tensor(pb), torch.as_tensor(meas))
    for j, t in ((je, te), (jja, tja), (jjb, tjb)):
        _close(j, t)
    _close(jse2.residual(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(meas)),
           tse2.residual(torch.as_tensor(pa), torch.as_tensor(pb),
                         torch.as_tensor(meas)))


@pytest.mark.parametrize("fn", ["fold_angle", "wrap_angle"])
def test_angle_folds_match(fn):
    t = np.random.default_rng(3).uniform(-20, 20, 1001)
    t[:4] = [0.0, np.pi / 2, -np.pi, np.pi]
    _close(getattr(jse2, fn)(jnp.asarray(t)),
           getattr(tse2, fn)(torch.as_tensor(t)))


def test_retract_is_additive(edges):
    pa, pb, _ = edges
    _close(jse2.retract(jnp.asarray(pa), jnp.asarray(pb)),
           tse2.retract(torch.as_tensor(pa), torch.as_tensor(pb)))


@pytest.fixture(scope="module")
def robust_inputs(edges):
    pa, pb, meas = edges
    e, Ja, Jb = tse2.residual_and_jacobians(
        torch.as_tensor(pa), torch.as_tensor(pb), torch.as_tensor(meas))
    e = e.numpy() * np.random.default_rng(5).uniform(0.001, 1.0, (len(pa), 1))
    return e, Ja.numpy(), Jb.numpy()


@pytest.mark.parametrize("name", ["huber_rho", "huber_weight"])
def test_huber_matches(name):
    s = np.random.default_rng(7).uniform(0, 0.001, 999)
    s[:3] = [0.0, 1e-4, 1e-4 + 1e-12]
    _close(getattr(jk, name)(jnp.asarray(s), 0.01),
           getattr(tk, name)(torch.as_tensor(s), 0.01))


def test_dcs_psi_and_scale_match(robust_inputs):
    e, Ja, Jb = robust_inputs
    _close(jk.dcs_psi(jnp.asarray(e), 0.5), tk.dcs_psi(torch.as_tensor(e),
                                                       0.5))
    js = jk.dcs_scale(jnp.asarray(e), jnp.asarray(Ja), jnp.asarray(Jb), 0.5)
    ts = tk.dcs_scale(torch.as_tensor(e), torch.as_tensor(Ja),
                      torch.as_tensor(Jb), 0.5)
    for j, t in zip(js, ts):
        _close(j, t)


def test_switch_kernels_match(robust_inputs):
    e, Ja, Jb = robust_inputs
    s = np.random.default_rng(9).uniform(0, 1, e.shape[0])
    js = jk.switch_scale(jnp.asarray(e), jnp.asarray(Ja), jnp.asarray(Jb),
                         jnp.asarray(s))
    ts = tk.switch_scale(torch.as_tensor(e), torch.as_tensor(Ja),
                         torch.as_tensor(Jb), torch.as_tensor(s))
    for j, t in zip(js, ts):
        _close(j, t)
    _close(jk.switch_prior_residual(jnp.asarray(s), 2.0),
           tk.switch_prior_residual(torch.as_tensor(s), 2.0))


def test_sc_varpro_matches(robust_inputs):
    e, Ja, Jb = robust_inputs
    js = jk.sc_varpro_scale(jnp.asarray(e), jnp.asarray(Ja), jnp.asarray(Jb),
                            1.0)
    ts = tk.sc_varpro_scale(torch.as_tensor(e), torch.as_tensor(Ja),
                            torch.as_tensor(Jb), 1.0)
    for j, t in zip(js, ts):
        _close(j, t)
    _close(jk.sc_varpro_switch(jnp.asarray(e), 1.0),
           tk.sc_varpro_switch(torch.as_tensor(e), 1.0))
