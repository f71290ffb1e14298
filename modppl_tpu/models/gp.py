"""Gaussian-process regression with hyperparameter inference.

Extension model family beyond the reference fixtures: a squared-
exponential GP prior over function values at a fixed input grid, with
log-scale hyperparameters (amplitude, length scale, observation noise) as
latents. The marginal likelihood is NON-quadratic in the log
hyperparameters, so HMC/ChEES take the fast generic gradient path
(inference/hmc._pooled_chains), while MAP/Laplace give the standard
empirical-Bayes point estimate. The covariance math stays on
ops/smalllinalg's unrolled custom-call-free forms for n <= 32 training
points.

Vectorized shape: the kernel matrix is built by broadcasting over the fixed
(n, n) grid of squared distances (precomputed once, closed over), and the
GP marginal ``y ~ N(0, K + sigma^2 I)`` is one ``mvnormal`` address, so
``assess``/``logjp`` and their gradients are a handful of fused
elementwise ops plus the unrolled Cholesky.
"""

import jax.numpy as jnp

from modppl_tpu.dists import mvnormal, normal
from modppl_tpu.modeling.gen import gen


def rbf_kernel(xs1, xs2, amp, length_scale):
    """Squared-exponential kernel matrix amp^2 exp(-d^2 / (2 ls^2))."""
    d2 = (jnp.asarray(xs1)[:, None] - jnp.asarray(xs2)[None, :]) ** 2
    return amp * amp * jnp.exp(-0.5 * d2 / (length_scale * length_scale))


def make_gp_model(xs, jitter=1e-6):
    """GP regression model over the fixed input grid ``xs``.

    Latents (unconstrained, standard-normal-ish priors on log scales):
    ``log_amp``, ``log_ls``, ``log_noise``. Observed: ``y`` (n-vector).
    """
    xs = jnp.asarray(xs, jnp.float32)
    n = xs.shape[0]
    d2 = (xs[:, None] - xs[None, :]) ** 2
    eye = jnp.eye(n, dtype=xs.dtype)

    @gen
    def gp_model(h):
        log_amp = h.sample(normal, (0.0, 1.0), "log_amp")
        log_ls = h.sample(normal, (0.0, 1.0), "log_ls")
        log_noise = h.sample(normal, (-2.0, 1.0), "log_noise")
        amp2 = jnp.exp(2.0 * log_amp)
        ls2 = jnp.exp(2.0 * log_ls)
        noise2 = jnp.exp(2.0 * log_noise)
        cov = amp2 * jnp.exp(-0.5 * d2 / ls2) + (noise2 + jitter) * eye
        return h.sample(mvnormal, (jnp.zeros(n, xs.dtype), cov), "y")

    return gp_model


def gp_posterior_predictive(xs, y, xstar, amp, length_scale, noise):
    """Closed-form GP posterior mean/variance at ``xstar``.

    Standard conjugate formulas (Rasmussen & Williams eq. 2.22-2.24),
    evaluated with the custom-call-free small-dim solves so the whole
    predictive is jittable inside scan bodies.
    """
    from modppl_tpu.ops.smalllinalg import solve_psd_small

    xs = jnp.asarray(xs, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    xstar = jnp.asarray(xstar, jnp.float32)
    K = rbf_kernel(xs, xs, amp, length_scale) \
        + noise * noise * jnp.eye(xs.shape[0], dtype=xs.dtype)
    Ks = rbf_kernel(xstar, xs, amp, length_scale)       # (m, n)
    Kss = rbf_kernel(xstar, xstar, amp, length_scale)   # (m, m)
    alpha = solve_psd_small(K, y[:, None])[:, 0]        # K^-1 y
    mean = Ks @ alpha
    v = solve_psd_small(K, Ks.T)                        # K^-1 Ks^T
    var = jnp.diagonal(Kss - Ks @ v)
    return mean, var
