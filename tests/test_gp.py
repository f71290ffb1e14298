"""GP regression model: logpdf oracle, predictive oracle, inference."""

import jax
import jax.numpy as jnp
import numpy as np

from modppl_tpu import Trie
from modppl_tpu.models.gp import (
    gp_posterior_predictive,
    make_gp_model,
    rbf_kernel,
)

XS = np.linspace(-2.0, 2.0, 12)


def _true_marginal_logpdf(y, amp, ls, noise, jitter=1e-6):
    K = (amp ** 2 * np.exp(-0.5 * (XS[:, None] - XS[None, :]) ** 2
                           / ls ** 2)
         + (noise ** 2 + jitter) * np.eye(len(XS)))
    n = len(XS)
    sign, logdet = np.linalg.slogdet(K)
    assert sign > 0
    return float(-0.5 * y @ np.linalg.solve(K, y) - 0.5 * logdet
                 - 0.5 * n * np.log(2 * np.pi))


def test_gp_assess_matches_dense_mvn_logpdf():
    """model.assess on fully-observed choices = hyperprior logpdfs + the
    exact dense multivariate-normal marginal."""
    from scipy import stats

    model = make_gp_model(XS)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(XS))
    la, ll, ln = 0.3, -0.2, -1.5
    c = Trie.from_dict({"log_amp": la, "log_ls": ll, "log_noise": ln,
                        "y": jnp.asarray(y, jnp.float32)})
    w = float(model.assess(jax.random.PRNGKey(0), (), c))
    expected = (stats.norm.logpdf(la, 0, 1) + stats.norm.logpdf(ll, 0, 1)
                + stats.norm.logpdf(ln, -2, 1)
                + _true_marginal_logpdf(y, np.exp(la), np.exp(ll),
                                        np.exp(ln)))
    np.testing.assert_allclose(w, expected, rtol=1e-4)


def test_gp_posterior_predictive_interpolates():
    """With tiny noise the posterior predictive passes through the
    training targets with near-zero variance, and matches the dense-
    linalg closed form at held-out points."""
    amp, ls, noise = 1.0, 0.7, 1e-3
    y = np.sin(XS)
    mean_tr, var_tr = gp_posterior_predictive(XS, y, XS, amp, ls, noise)
    np.testing.assert_allclose(np.asarray(mean_tr), y, atol=5e-3)
    assert float(jnp.max(var_tr)) < 1e-3

    xstar = np.asarray([-1.3, 0.4, 1.9])
    mean, var = gp_posterior_predictive(XS, y, xstar, amp, ls, noise)
    K = rbf_kernel(XS, XS, amp, ls) + noise ** 2 * np.eye(len(XS))
    Ks = np.asarray(rbf_kernel(xstar, XS, amp, ls))
    ref_mean = Ks @ np.linalg.solve(np.asarray(K), y)
    np.testing.assert_allclose(np.asarray(mean), ref_mean, rtol=1e-4,
                               atol=1e-5)
    assert np.all(np.asarray(var) > 0)


def test_gp_hyperparameter_map_recovers_scales():
    """MAP over the log hyperparameters of data drawn from a known GP
    lands near the generating values (empirical Bayes point estimate;
    the marginal is non-quadratic, so this exercises the generic
    gradient path end-to-end)."""
    from modppl_tpu.inference import map_optimize

    model = make_gp_model(XS)
    true = {"log_amp": 0.0, "log_ls": -0.3, "log_noise": -2.3}
    sim = Trie.from_dict(dict(true))
    # draw y from the model itself at the true hyperparameters
    tr, _ = model.generate(jax.random.PRNGKey(3), (), sim)
    y = tr.data.read("y")
    obs = Trie.from_dict({"y": y})
    out = map_optimize(jax.random.PRNGKey(0), model, (), obs,
                       num_steps=600, learning_rate=0.03)
    # 12 observations from one function draw: loose but meaningful gates
    assert abs(float(out["params"]["log_ls"]) - true["log_ls"]) < 1.0
    assert abs(float(out["params"]["log_amp"]) - true["log_amp"]) < 1.5
    # the fit must beat the prior-mean hyperparameters on the log-joint
    base = Trie.from_dict({"log_amp": 0.0, "log_ls": 0.0,
                           "log_noise": -2.0, "y": y})
    fit = Trie.from_dict({k: jnp.asarray(v) for k, v in
                          out["params"].items()} | {"y": y})
    assert float(model.assess(jax.random.PRNGKey(0), (), fit)) >= \
        float(model.assess(jax.random.PRNGKey(0), (), base)) - 1e-3


def test_gp_hmc_posterior_on_hyperparameters():
    """Pooled-adaptation HMC over the 3 log hyperparameters mixes and
    stays near the MAP (the posterior is unimodal here)."""
    from modppl_tpu.inference.hmc import hmc

    model = make_gp_model(XS)
    sim = Trie.from_dict({"log_amp": 0.0, "log_ls": -0.3,
                          "log_noise": -2.3})
    tr, _ = model.generate(jax.random.PRNGKey(3), (), sim)
    obs = Trie.from_dict({"y": tr.data.read("y")})
    out = hmc(jax.random.PRNGKey(0), model, (), obs, num_samples=150,
              num_warmup=75, num_chains=8, num_leapfrog=8)
    acc = float(np.mean(np.asarray(out["accept_prob"])))
    assert acc > 0.5
    ls_draws = np.asarray(out["samples"]["log_ls"])[:, 75:]
    assert abs(ls_draws.mean() - (-0.3)) < 1.2
