"""Multivariate normal distribution.

Reference parity: ``mvnormal`` (modppl/src/modeling/dists/mvnormal.rs:13-38).
The reference computes the logpdf via explicit determinant + inverse
(mvnormal.rs:14-22); here both logpdf and sampling go through one Cholesky
factorization, with an eager symmetric-eigendecomposition fallback for
non-PD covariance matching mvnormal.rs:27-35.

For the small static dims PPL models actually use (k <= 32), the
factorization and solves run as *unrolled elementwise jnp ops*
(ops/smalllinalg.py) rather than ``jnp.linalg`` custom calls — an XLA
cholesky/triangular_solve custom call cannot fuse, while the unrolled form
is plain arithmetic that fuses into the surrounding log-joint. Large-k
inputs fall back to the stock batched ``jnp.linalg`` path.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.dists.base import Distribution, _f
from modppl_tpu.ops.smalllinalg import (
    SMALL_DIM_MAX,
    cholesky_small,
    matvec_small,
    solve_lower_small,
    tril_logdet_small,
)


def _chol(cov):
    if cov.shape[-1] <= SMALL_DIM_MAX:
        return cholesky_small(cov)
    return jnp.linalg.cholesky(cov)


def _solve_lower(L, b):
    if L.shape[-1] <= SMALL_DIM_MAX:
        return solve_lower_small(L, b)
    return jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)[..., 0]


class MvNormal(Distribution):
    """Multivariate Gaussian over vectors; params (mean vector, covariance matrix)."""

    def _logpdf(self, x, mu, cov):
        x, mu, cov = _f(x), _f(mu), _f(cov)
        k = mu.shape[-1]
        chol = _chol(cov)
        # solve L z = (x - mu); mahalanobis^2 = |z|^2 ; log|cov| = 2 sum log diag L
        z = _solve_lower(chol, x - mu)
        logdet = 2.0 * tril_logdet_small(chol)
        maha = jnp.sum(z * z, axis=-1)
        return -(k * jnp.log(2.0 * jnp.pi) + logdet + maha) / 2.0

    def _transform(self, cov):
        chol = _chol(cov)
        if not isinstance(chol, jax.core.Tracer) and bool(jnp.any(jnp.isnan(chol))):
            # non-PD fallback (mvnormal.rs:30-34): eigvec * diag(sqrt(eigval))
            w, v = jnp.linalg.eigh(cov)
            return v * jnp.sqrt(jnp.clip(w, 0.0))[..., None, :]
        return chol

    def _sample(self, key, mu, cov):
        mu, cov = _f(mu), _f(cov)
        z = jax.random.normal(key, mu.shape, dtype=mu.dtype)
        t = self._transform(cov)
        if mu.shape[-1] <= SMALL_DIM_MAX:
            return mu + matvec_small(t, z)
        return mu + (t @ z[..., None])[..., 0]


mvnormal = MvNormal()
