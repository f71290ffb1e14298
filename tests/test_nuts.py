"""NUTS tests against analytic posteriors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu import Trie, gen, normal
from modppl_tpu.dists.iid import iid
from modppl_tpu.inference.nuts import nuts


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")


def test_nuts_conjugate_posterior():
    obs = Trie.from_dict({"x": 1.0})
    out = nuts(jax.random.PRNGKey(0), conjugate, (), obs,
               num_samples=800, num_warmup=400, num_chains=4, max_depth=6)
    mus = np.asarray(out["samples"]["mu"]).ravel()
    assert mus.mean() == pytest.approx(0.5, abs=0.05)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    assert float(jnp.mean(out["divergences"])) < 0.01
    # trees should expand beyond a single doubling on a smooth target
    assert float(jnp.mean(out["tree_depth"])) > 1.0


ys11 = iid(normal, 11)


@gen
def linreg(h, xs):
    slope = h.sample(normal, (0.0, 1.0), "slope")
    intercept = h.sample(normal, (0.0, 2.0), "intercept")
    h.sample(ys11, (slope * xs + intercept, 0.1), "ys")


def test_nuts_linreg_posterior():
    # exact Gaussian posterior oracle, correlated scales -> exercises the
    # mass adaptation + dynamic trajectory length
    xs = jnp.linspace(-5.0, 5.0, 11)
    ys = 0.5 * xs - 1.0
    obs = Trie.from_dict({"ys": ys})
    out = nuts(jax.random.PRNGKey(1), linreg, (xs,), obs,
               num_samples=1000, num_warmup=500, num_chains=4, max_depth=8)
    s = np.asarray(out["samples"]["slope"]).ravel()
    i = np.asarray(out["samples"]["intercept"]).ravel()

    X = np.stack([np.asarray(xs), np.ones(11)], 1)
    post_cov = np.linalg.inv(np.diag([1.0, 0.25]) + 100.0 * X.T @ X)
    post_mean = post_cov @ (100.0 * X.T @ np.asarray(ys))
    assert s.mean() == pytest.approx(post_mean[0], abs=0.005)
    assert i.mean() == pytest.approx(post_mean[1], abs=0.02)
    assert s.std() == pytest.approx(np.sqrt(post_cov[0, 0]), rel=0.15)
    assert i.std() == pytest.approx(np.sqrt(post_cov[1, 1]), rel=0.15)


def test_nuts_funnel_divergences():
    """Neal's funnel: v ~ N(0, 3), x_i | v ~ N(0, exp(v/2)) (i < 4).

    Without reparameterization NUTS must (a) report divergences when run
    with a large fixed step size in the neck, and (b) with adaptation,
    still recover the exact N(0, 3) marginal of v reasonably while
    flagging few divergences — the standard stress test for the
    divergence bookkeeping (Hoffman-Gelman 2014 §5; Betancourt 2016).
    """
    xs4 = iid(normal, 4)

    @gen
    def funnel(h):
        v = h.sample(normal, (0.0, 3.0), "v")
        h.sample(xs4, (0.0, jnp.exp(0.5 * v)), "x")

    # (a) deliberately coarse fixed step size: the integrator must blow up
    # somewhere in the neck and the divergence flag must fire
    out_bad = nuts(jax.random.PRNGKey(2), funnel, (), Trie(),
                   num_samples=150, num_warmup=0, num_chains=8,
                   step_size=1.5, max_depth=6)
    assert float(jnp.mean(out_bad["divergences"])) > 0.02

    # (b) adapted: low divergence rate, v-marginal near N(0,3) (generous
    # tolerances: the funnel neck is genuinely hard without reparam).
    # target 0.99 (was 0.9): with the round-5 mass-convention fix the
    # metric is the (mouth-dominated) marginal variance, so only a small
    # step size lets trajectories enter the neck — the canonical funnel
    # behavior of variance-metric HMC (Stan behaves the same); at 0.9 the
    # v-marginal biases high (measured +1.08), at 0.99 it is exact
    # (-0.02 +- , std 2.81)
    out = nuts(jax.random.PRNGKey(3), funnel, (), Trie(),
               num_samples=1500, num_warmup=800, num_chains=8,
               max_depth=8, target_accept=0.99)
    vs = np.asarray(out["samples"]["v"]).ravel()
    assert float(jnp.mean(out["divergences"])) < 0.1
    assert vs.mean() == pytest.approx(0.0, abs=0.6)
    assert vs.std() == pytest.approx(3.0, rel=0.25)


def test_nuts_matches_hmc_on_correlated_target():
    """NUTS and generic HMC agree (posterior mean/cov) on a correlated
    2D Gaussian posterior, and NUTS matches the analytic quantiles."""
    from modppl_tpu.inference.hmc import hmc

    xs = jnp.linspace(-5.0, 5.0, 11)
    ys = 0.5 * xs - 1.0
    obs = Trie.from_dict({"ys": ys})
    kwargs = dict(num_samples=1000, num_warmup=500, num_chains=4)
    out_n = nuts(jax.random.PRNGKey(4), linreg, (xs,), obs, max_depth=8,
                 **kwargs)
    out_h = hmc(jax.random.PRNGKey(5), linreg, (xs,), obs, num_leapfrog=16,
                **kwargs)

    X = np.stack([np.asarray(xs), np.ones(11)], 1)
    post_cov = np.linalg.inv(np.diag([1.0, 0.25]) + 100.0 * X.T @ X)
    post_mean = post_cov @ (100.0 * X.T @ np.asarray(ys))

    for out in (out_n, out_h):
        s = np.asarray(out["samples"]["slope"]).ravel()
        i = np.asarray(out["samples"]["intercept"]).ravel()
        samp = np.stack([s, i], 1)
        np.testing.assert_allclose(samp.mean(0), post_mean, atol=0.02)
        np.testing.assert_allclose(np.cov(samp.T), post_cov, atol=2e-4)

    # quantile check vs the analytic marposterior: slope 5/95 quantiles
    s_n = np.asarray(out_n["samples"]["slope"]).ravel()
    from scipy.stats import norm as sps_norm
    for q in (0.05, 0.25, 0.5, 0.75, 0.95):
        want = post_mean[0] + np.sqrt(post_cov[0, 0]) * sps_norm.ppf(q)
        got = np.quantile(s_n, q)
        assert got == pytest.approx(want, abs=3e-3), q


def test_nuts_pooled_matches_per_chain_statistically():
    obs = Trie.from_dict({"x": 1.0})
    pooled = nuts(jax.random.PRNGKey(6), conjugate, (), obs,
                  num_samples=600, num_warmup=300, num_chains=8,
                  max_depth=6, pooled_adaptation=True)
    per = nuts(jax.random.PRNGKey(7), conjugate, (), obs,
               num_samples=600, num_warmup=300, num_chains=8,
               max_depth=6, pooled_adaptation=False)
    mp = np.asarray(pooled["samples"]["mu"]).ravel()
    mq = np.asarray(per["samples"]["mu"]).ravel()
    assert mp.mean() == pytest.approx(0.5, abs=0.05)
    assert mq.mean() == pytest.approx(0.5, abs=0.05)
    assert mp.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
