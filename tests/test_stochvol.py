"""Stochastic volatility filtering: batched filter vs Kalman-free oracles.

The SV model has no closed-form log-ML; gates are (a) a near-exact
grid-enumeration oracle on a short series, and (b) internal consistency
(ESS-triggered resampling actually fires; posterior volatility tracks the
true path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu import Trie
from modppl_tpu.inference.vsmc import batched_particle_filter
from modppl_tpu.models.stochvol import SVParams, simulate_sv, sv_scan_kernel


def _constraints(ys):
    init_c = Trie.from_dict({"y": jnp.asarray(ys[0])})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[Trie.from_dict({"y": jnp.asarray(y)}) for y in ys[1:]])
    return init_c, step_c


def _grid_log_ml(ys, params, m=400, lo=-4.0, hi=2.0):
    """Discretized-HMM oracle: exact filtering on an m-point h-grid."""
    import scipy.stats as st

    mu, phi, sigma, beta = params.mu, params.phi, params.sigma, params.beta
    grid = np.linspace(lo, hi, m)
    w = grid[1] - grid[0]
    sd0 = sigma / np.sqrt(1 - phi * phi)
    # transition density matrix T[i, j] = p(h_t = g_j | h_{t-1} = g_i) * w
    trans = st.norm(mu + phi * (grid[:, None] - mu), sigma).pdf(grid[None, :]) * w
    alpha = st.norm(mu, sd0).pdf(grid) * w
    total = 0.0
    for t, y in enumerate(ys):
        if t > 0:
            alpha = alpha @ trans
        like = st.norm(0.0, beta * np.exp(grid / 2.0)).pdf(y)
        alpha = alpha * like
        s = alpha.sum()
        total += np.log(s)
        alpha /= s
    return total


def test_sv_filter_log_ml_matches_grid_oracle():
    params = SVParams()
    _, ys = simulate_sv(jax.random.PRNGKey(0), 12, params)
    ys = np.asarray(ys)
    want = _grid_log_ml(ys, params)
    init_c, step_c = _constraints(ys)
    out = batched_particle_filter(
        jax.random.PRNGKey(1), sv_scan_kernel(params), jnp.zeros(()),
        init_c, step_c, 8192, ess_threshold=0.5, auto_batch=True)
    assert float(out["log_ml"]) == pytest.approx(want, abs=0.1)
    # adaptive resampling fired at least once but not every step
    fired = int(np.sum(np.asarray(out["resampled"])))
    assert 0 < fired


def test_sv_posterior_tracks_true_volatility():
    params = SVParams(sigma=0.3)
    hs, ys = simulate_sv(jax.random.PRNGKey(2), 30, params)
    init_c, step_c = _constraints(np.asarray(ys))
    out = batched_particle_filter(
        jax.random.PRNGKey(3), sv_scan_kernel(params), jnp.zeros(()),
        init_c, step_c, 4096, ess_threshold=0.5, auto_batch=True)
    # final-step filtering mean within a few posterior sds of the truth
    w = jnp.exp(out["log_weights"] - jax.scipy.special.logsumexp(
        out["log_weights"]))
    mean = float(jnp.sum(w * out["state"]))
    sd = float(jnp.sqrt(jnp.sum(w * (out["state"] - mean) ** 2)))
    assert abs(mean - float(hs[-1])) < 4 * sd + 0.5


def test_stochvol_joint_hmc_recovers_path():
    """Round 5: whole-path HMC on the non-centered joint form
    (models/stochvol.make_stochvol_joint) — the posterior volatility path
    tracks the simulated truth and the adapted sampler sits at a healthy
    accept rate."""
    from modppl_tpu import Trie
    from modppl_tpu.inference.hmc import hmc
    from modppl_tpu.models.stochvol import (
        SVParams,
        make_stochvol_joint,
        simulate_sv,
        volatility_path,
    )

    T = 32
    # a more informative regime than the daily-returns default (sigma
    # 0.8, phi 0.9): with sigma 0.15 a single y_t pins h_t so weakly
    # that even the exact posterior mean correlates ~0.15 with the truth
    params = SVParams(mu=-1.0, phi=0.9, sigma=0.8)
    h_true, ys = simulate_sv(jax.random.PRNGKey(0), T, params)
    model = make_stochvol_joint(T, params)

    out = hmc(jax.random.PRNGKey(2), model, (ys,), Trie(),
              num_samples=400, num_warmup=300, num_chains=16,
              num_leapfrog=16)
    acc = float(jnp.mean(np.asarray(out["accept_prob"])))
    assert 0.5 < acc < 0.99, acc
    zs = np.asarray(out["samples"]["z"])[:, 200:]          # (chains, draws, T)
    hs = np.asarray(volatility_path(jnp.asarray(zs), params))
    h_mean = hs.reshape(-1, T).mean(0)
    # the posterior path must correlate with the simulated truth (the
    # observations are informative where |y| is large) and stay within
    # the prior's plausible band
    corr = np.corrcoef(h_mean, np.asarray(h_true))[0, 1]
    assert corr > 0.4, corr
    assert np.all(np.abs(h_mean - params.mu) < 4.0)
