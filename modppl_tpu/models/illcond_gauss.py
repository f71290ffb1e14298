"""Correlated, ill-conditioned Gaussian target for HMC/NUTS stress tests.

A single d-dimensional ``mvnormal`` latent whose covariance has log-spaced
eigenvalues spanning ``cond`` (default 10^4) mixed by a deterministic
orthogonal rotation — so the posterior is exactly N(0, Σ) but every
coordinate couples every eigendirection. This is the mass-matrix stress
target VERDICT r3 asked for: single-coordinate ESS on a near-isotropic toy
cannot detect adaptation regressions; MIN-across-coordinates ESS here can.

The unconstrained log-density is quadratic (logp = -1/2 uᵀΛu + const with
Λ = Σ⁻¹) and runs the generic pooled HMC path (bench.py leg 3).
"""

import numpy as np
import jax.numpy as jnp

from modppl_tpu.dists import mvnormal
from modppl_tpu.modeling import gen


def illcond_cov(d, cond=1e4, seed=0, dtype=np.float32):
    """Σ = Q diag(λ) Qᵀ with λ log-spaced in [1/cond, 1] and Q a fixed
    random orthogonal matrix (deterministic in ``seed``)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.logspace(-np.log10(cond), 0.0, d)
    cov = (q * lam) @ q.T
    cov = 0.5 * (cov + cov.T)  # exact symmetry for Cholesky
    return jnp.asarray(cov, dtype)


def make_illcond_gauss(d, cond=1e4, seed=0):
    """Model with one latent address "x" ~ N(0, Σ_illcond)."""
    cov = illcond_cov(d, cond, seed)
    mean = jnp.zeros((d,), cov.dtype)

    @gen
    def illcond_gauss(h):
        return h.sample(mvnormal, (mean, cov), "x")

    return illcond_gauss
