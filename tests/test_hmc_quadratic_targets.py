"""The generic pooled HMC path on Gaussian (quadratic) targets.

Every target runs inference/hmc._pooled_chains, the conjugate and
linear-Gaussian zoo included. These targets have closed-form posteriors,
so each test checks moments against the exact values within a stated
number of Monte Carlo standard errors (MCSE from Geyer's ESS).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu import Trie, gen, normal
from modppl_tpu.dists.iid import iid
from modppl_tpu.inference.hmc import _pooled_chains, hmc, hmc_transition
from modppl_tpu.models.hierarchical_static import (
    NOISE,
    exact_hierarchical_posterior,
    make_hierarchical_static,
)
from modppl_tpu.models.illcond_gauss import illcond_cov, make_illcond_gauss
from modppl_tpu.utils.diagnostics import ess_autocorr

K = 5.0   # a correct sampler exceeds 5 MCSE with p < 1e-6 per quantity


def _assert_moments(draws, mean, var):
    """draws (chains, n, d): per-coordinate mean and variance within K
    MCSE of the exact values."""
    draws = np.asarray(draws, np.float64)
    for j in range(draws.shape[-1]):
        x = draws[..., j]
        mcse = x.std() / math.sqrt(ess_autocorr(x))
        assert abs(x.mean() - mean[j]) < K * mcse, (j, x.mean(), mean[j])
        sq = (x - mean[j]) ** 2
        mcse_sq = sq.std() / math.sqrt(ess_autocorr(sq))
        assert abs(sq.mean() - var[j]) < K * mcse_sq, (j, sq.mean(), var[j])


def test_conjugate_d3_moments():
    xs = np.linspace(-1.0, 1.0, 10)
    ys = (0.3 + 0.5 * xs - 0.8 * xs * xs
          + NOISE * np.random.default_rng(0).standard_normal(10))
    obs = Trie.from_dict({"ys": jnp.asarray(ys), "is_linear": False})
    out = hmc(jax.random.PRNGKey(0), make_hierarchical_static(10),
              (jnp.asarray(xs),), obs, num_samples=300, num_warmup=200,
              num_chains=64, num_leapfrog=8)
    _, _, _, m_quad, c_quad, _ = exact_hierarchical_posterior(xs, ys)
    _assert_moments(out["unconstrained"], m_quad, np.diag(c_quad))
    assert not np.asarray(out["divergences"]).any()


@pytest.mark.parametrize("dim", [10, 32])
def test_illcond_gauss_moments(dim):
    cond = 100.0
    out = hmc(jax.random.PRNGKey(dim), make_illcond_gauss(dim, cond), (),
              Trie(), num_samples=100, num_warmup=150, num_chains=32,
              num_leapfrog=8)
    var = np.diag(np.asarray(illcond_cov(dim, cond), np.float64))
    _assert_moments(out["unconstrained"], np.zeros(dim), var)
    assert 0.5 < float(np.mean(np.asarray(out["accept_prob"]))) <= 1.0


def test_warmup_adapts_step_size_and_diagonal_mass():
    """The pooled windowed warmup sets inv_mass (= M^-1) to the marginal
    variances of a correlated Gaussian and dual averaging settles the step
    size near the 0.8 accept target."""
    dim, cond = 6, 50.0
    out = hmc(jax.random.PRNGKey(1), make_illcond_gauss(dim, cond), (),
              Trie(), num_samples=100, num_warmup=300, num_chains=256,
              num_leapfrog=8)
    var = np.diag(np.asarray(illcond_cov(dim, cond), np.float64))
    np.testing.assert_allclose(np.asarray(out["inv_mass"]), var, rtol=0.25)
    assert 0.05 < float(out["step_size"]) < 2.0
    assert 0.6 < float(np.mean(np.asarray(out["accept_prob"]))) < 0.95


@gen
def _conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 0.5), "x")
    return mu


def test_zero_warmup_keeps_initial_step_and_unit_mass():
    """num_warmup=0 runs the sampling phase at the given step size and
    the identity metric, and still targets N(0.8, 0.2)."""
    out = hmc(jax.random.PRNGKey(0), _conjugate, (),
              Trie.from_dict({"x": 1.0}), num_samples=400, num_warmup=0,
              num_chains=32, step_size=0.3, num_leapfrog=6)
    assert np.asarray(out["unconstrained"]).shape == (32, 400, 1)
    np.testing.assert_allclose(float(out["step_size"]), 0.3, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out["inv_mass"]), np.ones(1))
    _assert_moments(np.asarray(out["unconstrained"])[:, 50:], [0.8], [0.2])


def test_divergent_chain_does_not_poison_pooled_adaptation():
    """A chain started where the log-density overflows diverges on every
    transition and stays put; the pooled (eps, inv_mass) must still be
    the healthy chains' adaptation and their draws the exact posterior."""
    sds = np.array([0.5, 1.0, 2.0])
    x3 = iid(normal, 3)

    def logprob(u):
        return jnp.sum(x3.logpdf(u, (0.0, jnp.asarray(sds, u.dtype))))

    u0s = jax.random.normal(jax.random.PRNGKey(0), (128, 3), jnp.float32)
    u0s = u0s.at[0].set(3e19)      # u^2 overflows float32: logp = -inf
    us, logps, aprobs, divs, eps, inv_mass = jax.jit(
        lambda u: _pooled_chains(jax.random.PRNGKey(1), logprob, u, 300,
                                 200, 0.1, 8, 0.8))(u0s)
    assert bool(np.asarray(divs)[0].all())
    np.testing.assert_array_equal(np.asarray(us)[0],
                                  np.broadcast_to(u0s[0], (200, 3)))
    assert np.isfinite(float(eps)) and 0.05 < float(eps) < 3.0
    np.testing.assert_allclose(np.asarray(inv_mass), sds ** 2, rtol=0.25)
    assert not np.asarray(divs)[1:].any()
    _assert_moments(np.asarray(us)[1:], np.zeros(3), sds ** 2)


@pytest.mark.parametrize("dim", [2, 6])
def test_hmc_transition_leaves_gaussian_invariant(dim):
    """One transition applied to exact draws of N(0, Σ) returns draws of
    N(0, Σ): mean and covariance within 5 standard errors."""
    cov = np.asarray(illcond_cov(dim, 20.0, seed=dim), np.float64)
    prec = jnp.asarray(np.linalg.inv(cov))
    chol = np.linalg.cholesky(cov)
    n = 40_000
    z = np.random.default_rng(dim).standard_normal((n, dim))
    u = jnp.asarray(z @ chol.T)

    def logp(v):
        return -0.5 * v @ prec @ v

    inv_mass = jnp.asarray(np.diag(cov))
    step = jax.jit(jax.vmap(lambda k, v: hmc_transition(
        k, v, logp, jax.grad(logp), 0.4, 5, inv_mass)))
    u1, _, aprob, div = step(jax.random.split(jax.random.PRNGKey(2), n), u)
    u1 = np.asarray(u1)
    assert 0.3 < float(np.mean(np.asarray(aprob))) < 0.99   # moves happen
    assert not np.asarray(div).any()
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(u1.mean(0)) < K * sd / math.sqrt(n))
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / n)
    assert np.all(np.abs(np.cov(u1.T) - cov) < K * se)
