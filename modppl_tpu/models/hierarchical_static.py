"""Saturated (static-structure) form of the hierarchical model.

The compiled-tier counterpart of models/hierarchical.py (reference:
modppl/tests/dyngenfns/hierarchical.rs:32-46). The bernoulli gate's data
dependence moves from *structure* (which addresses exist) into *values*
(`c` is always sampled — a prior-scored auxiliary when the model is linear —
and its effect on the regression mean is masked with `where`). The posterior
over (is_linear, a, b, and c-when-quadratic) is identical to the reference
model's; the trace structure is static, so the whole model jits, vmaps over
a particle/chain axis, and shards over a mesh.

Observations use one plated address "ys" (a single vector leaf with summed
log-density) instead of the reference's per-index `(y, i)` addresses — one
fused kernel instead of N scalar sites.
"""

import jax.numpy as jnp

from modppl_tpu.dists import bernoulli, normal
from modppl_tpu.dists.iid import iid
from modppl_tpu.modeling import gen

NOISE = 0.1


def make_hierarchical_static(n_points):
    """Build the saturated model for a fixed number of data points."""

    ys_dist = iid(normal, n_points)

    @gen
    def hierarchical_static(h, xs):
        xs = jnp.asarray(xs)
        is_linear = h.sample(bernoulli, 0.7, "is_linear")
        a = h.sample(normal, (0.0, 1.0), "coeffs/a")
        b = h.sample(normal, (0.0, 1.0), "coeffs/b")
        c = h.sample(normal, (0.0, 1.0), "coeffs/c")
        c_eff = jnp.where(is_linear, 0.0, c)
        mean = a + b * xs + c_eff * xs * xs
        return h.sample(ys_dist, (mean, NOISE), "ys")

    return hierarchical_static


def exact_hierarchical_posterior(xs, ys, noise=NOISE, p_linear=0.7,
                                 prior_std=(1.0, 1.0, 1.0)):
    """Analytic posterior for the saturated hierarchical model.

    Conjugate linear-Gaussian evidence for each branch gives the exact
    P(is_linear | ys) and per-branch coefficient posteriors — the
    quantitative oracle replacing the reference's visual checks.

    Returns (p_linear_post, mean_lin[2], cov_lin, mean_quad[3], cov_quad,
    log_evidence).
    """
    import numpy as np

    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)

    def evidence(design, prior_var):
        n, k = design.shape
        prior_cov = np.diag(prior_var)
        s = design @ prior_cov @ design.T + noise ** 2 * np.eye(n)
        sign, logdet = np.linalg.slogdet(2 * np.pi * s)
        log_ev = -0.5 * (logdet + ys @ np.linalg.solve(s, ys))
        post_prec = np.diag(1.0 / np.asarray(prior_var)) + design.T @ design / noise ** 2
        post_cov = np.linalg.inv(post_prec)
        post_mean = post_cov @ (design.T @ ys) / noise ** 2
        return log_ev, post_mean, post_cov

    X_lin = np.stack([np.ones_like(xs), xs], axis=1)
    X_quad = np.stack([np.ones_like(xs), xs, xs * xs], axis=1)
    lev_lin, m_lin, c_lin = evidence(X_lin, prior_var=np.array(prior_std[:2]) ** 2)
    lev_quad, m_quad, c_quad = evidence(X_quad, prior_var=np.array(prior_std) ** 2)

    lw_lin = np.log(p_linear) + lev_lin
    lw_quad = np.log(1.0 - p_linear) + lev_quad
    m = max(lw_lin, lw_quad)
    log_z = m + np.log(np.exp(lw_lin - m) + np.exp(lw_quad - m))
    p_lin_post = np.exp(lw_lin - log_z)
    return p_lin_post, m_lin, c_lin, m_quad, c_quad, log_z


def make_hierarchical_marginalized(n_points, p_linear=0.7):
    """Hierarchical model with the discrete gate summed out.

    log p(ys | a,b,c) = logaddexp(log p_lin + sum_i logN(y_i; a+bx, s),
                                  log (1-p_lin) + sum_i logN(y_i; a+bx+cx^2, s))
    expressed through the `factor` primitive — the fully-continuous form the
    gradient samplers (HMC/NUTS) run on. P(is_linear | ys, coeffs) can be
    recovered in closed form from the two branch log-likelihoods.
    """

    @gen
    def hierarchical_marginalized(h, xs, ys):
        xs = jnp.asarray(xs)
        ys = jnp.asarray(ys)
        a = h.sample(normal, (0.0, 1.0), "coeffs/a")
        b = h.sample(normal, (0.0, 1.0), "coeffs/b")
        c = h.sample(normal, (0.0, 1.0), "coeffs/c")
        mean_lin = a + b * xs
        mean_quad = mean_lin + c * xs * xs
        ll_lin = jnp.sum(normal.logpdf(ys, (mean_lin, NOISE)))
        ll_quad = jnp.sum(normal.logpdf(ys, (mean_quad, NOISE)))
        h.factor(jnp.logaddexp(jnp.log(p_linear) + ll_lin,
                               jnp.log(1.0 - p_linear) + ll_quad), "ys_marginal")
        return ll_quad - ll_lin  # log odds contribution for gate recovery

    return hierarchical_marginalized
