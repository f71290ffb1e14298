"""Logistic-regression model (models/logreg.py): the non-quadratic HMC
bench target. Checks (1) the generic pooled path recovers the posterior
mode region, (2) MAP oracle self-consistency."""

import jax
import jax.numpy as jnp
import numpy as np

from modppl_tpu import Trie
from modppl_tpu.inference.hmc import hmc
from modppl_tpu.models.logreg import make_logreg, map_newton, simulate_logreg


def test_logreg_hmc_posterior_near_map():
    d, n = 2, 400
    X, ys, w_true = simulate_logreg(
        jax.random.PRNGKey(2), n, d, w_true=jnp.array([1.0, -1.0]))
    model = make_logreg(d)
    out = hmc(jax.random.PRNGKey(3), model, (X, ys), Trie(),
              num_samples=300, num_warmup=200, num_chains=16,
              num_leapfrog=8)
    w_map = map_newton(X, ys)
    ws = np.asarray(out["samples"]["w"])[:, 100:].reshape(-1, d)
    # posterior mean within a posterior-sd-scale ball of the MAP
    np.testing.assert_allclose(ws.mean(0), w_map, atol=0.1)
    # and the MAP itself recovered the truth direction
    np.testing.assert_allclose(w_map, np.array([1.0, -1.0]), atol=0.5)
