"""LGSSM family: Kalman filter/smoother (sequential vs time-parallel) and
the SMC log-ML gate against the exact Kalman evidence.

The linear-Gaussian analog of the reference's HMM gate
(modppl/tests/particle_filter.rs:36-78): where that test anchors the
particle filter to the discrete forward algorithm, these anchor it to the
Kalman filter — and additionally pin the associative-scan (O(log T) depth)
filter/smoother to the lax.scan forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu.inference.kalman import (
    kalman_filter,
    kalman_filter_parallel,
    kalman_smoother,
    kalman_smoother_parallel,
)
from modppl_tpu.models.lgssm import lgssm_scan_kernel, lgssm_simulate, make_lgssm


def _params(D=3, E=2, seed=0):
    rng = np.random.default_rng(seed)
    A = 0.9 * np.linalg.qr(rng.normal(size=(D, D)))[0]
    Q = 0.1 * np.eye(D)
    H = rng.normal(size=(E, D))
    R = 0.5 * np.eye(E)
    return make_lgssm(A, Q, H, R, np.zeros(D), np.eye(D))


@pytest.fixture(scope="module")
def lgssm_data():
    params = _params()
    xs, ys = lgssm_simulate(jax.random.PRNGKey(0), params, 50)
    return params, xs, ys


def test_parallel_filter_matches_sequential(lgssm_data):
    params, _, ys = lgssm_data
    seq = kalman_filter(params, ys)
    par = kalman_filter_parallel(params, ys)
    np.testing.assert_allclose(par["means"], seq["means"], atol=1e-8)
    np.testing.assert_allclose(par["covs"], seq["covs"], atol=1e-8)
    np.testing.assert_allclose(par["log_ml"], seq["log_ml"], atol=1e-8)
    np.testing.assert_allclose(par["step_log_liks"], seq["step_log_liks"],
                               atol=1e-8)


def test_parallel_smoother_matches_sequential(lgssm_data):
    params, _, ys = lgssm_data
    seq = kalman_smoother(params, ys)
    par = kalman_smoother_parallel(params, ys)
    np.testing.assert_allclose(par["means"], seq["means"], atol=1e-8)
    np.testing.assert_allclose(par["covs"], seq["covs"], atol=1e-8)


def test_smoother_final_step_equals_filter(lgssm_data):
    params, _, ys = lgssm_data
    filt = kalman_filter(params, ys)
    smth = kalman_smoother(params, ys)
    np.testing.assert_allclose(smth["means"][-1], filt["means"][-1],
                               atol=1e-10)
    np.testing.assert_allclose(smth["covs"][-1], filt["covs"][-1], atol=1e-10)
    # smoothing reduces (or preserves) marginal variance at every step
    assert bool(jnp.all(jnp.diagonal(smth["covs"], axis1=1, axis2=2)
                        <= jnp.diagonal(filt["covs"], axis1=1, axis2=2) + 1e-9))


def test_scalar_lgssm_analytic():
    # 1-D model with H = 1: one filter step has the textbook closed form.
    params = make_lgssm([[0.9]], [[0.2]], [[1.0]], [[0.3]], [0.0], [[1.0]])
    ys = jnp.array([[0.7]])
    out = kalman_filter(params, ys)
    S = 1.0 + 0.3
    expected_mean = (1.0 / S) * 0.7
    expected_cov = 1.0 - 1.0 / S
    expected_ll = -0.5 * (np.log(2 * np.pi * S) + 0.7 ** 2 / S)
    np.testing.assert_allclose(out["means"][0, 0], expected_mean, atol=1e-12)
    np.testing.assert_allclose(out["covs"][0, 0, 0], expected_cov, atol=1e-12)
    np.testing.assert_allclose(out["log_ml"], expected_ll, atol=1e-12)


def test_smc_log_ml_matches_kalman(lgssm_data):
    """Bootstrap SMC on the LGSSM vs the exact Kalman evidence — the
    linear-Gaussian counterpart of the HMM forward gate
    (modppl/tests/particle_filter.rs:76)."""
    from modppl_tpu import Trie
    from modppl_tpu.inference.vsmc import particle_filter

    params = _params(D=2, E=1, seed=1)
    _, ys = lgssm_simulate(jax.random.PRNGKey(3), params, 8)
    exact = kalman_filter(params, ys)["log_ml"]

    kernel = lgssm_scan_kernel(params)
    init_c = Trie.from_dict({"obs": ys[0]})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[Trie.from_dict({"obs": y}) for y in ys[1:]])
    out = particle_filter(
        jax.random.PRNGKey(4), kernel, jnp.zeros(2), init_c, step_c,
        num_particles=4096, store_traces=False)
    assert abs(float(out["log_ml"]) - float(exact)) < 0.08, (
        float(out["log_ml"]), float(exact))


def test_kalman_hlo_no_custom_calls(lgssm_data):
    """Hot-path rule (ops/smalllinalg.py): at small static D the whole
    filter — sequential and time-parallel — must lower without any XLA
    custom call (cholesky/triangular-solve/LU all route through
    ops/smalllinalg.py unrolled forms)."""
    from modppl_tpu.utils.profiling import hlo_text

    params, _, ys = lgssm_data
    for fn in (kalman_filter, kalman_filter_parallel,
               kalman_smoother, kalman_smoother_parallel):
        txt = hlo_text(fn, params, ys)
        assert "custom-call" not in txt, fn.__name__


def test_small_solves_match_linalg():
    """solve_psd_small / lu_solve_small vs jnp.linalg at f64."""
    from modppl_tpu.ops.smalllinalg import lu_solve_small, solve_psd_small

    rng = np.random.default_rng(7)
    for k in (1, 2, 3, 5, 8):
        M = rng.normal(size=(4, k, k))
        S = M @ np.swapaxes(M, -1, -2) + k * np.eye(k)
        B = rng.normal(size=(4, k, 3))
        b = rng.normal(size=(4, k))
        np.testing.assert_allclose(
            np.asarray(solve_psd_small(jnp.asarray(S), jnp.asarray(B))),
            np.linalg.solve(S, B), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(solve_psd_small(jnp.asarray(S), jnp.asarray(b))),
            np.linalg.solve(S, b[..., None])[..., 0], rtol=1e-9, atol=1e-9)
        # general (non-symmetric, needs pivoting: first pivot is tiny)
        G = rng.normal(size=(4, k, k))
        G[:, 0, 0] = 1e-30
        np.testing.assert_allclose(
            np.asarray(lu_solve_small(jnp.asarray(G), jnp.asarray(B))),
            np.linalg.solve(G, B), rtol=1e-7, atol=1e-7)
