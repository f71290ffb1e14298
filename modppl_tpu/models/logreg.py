"""Bayesian logistic regression: the non-quadratic HMC benchmark target.

The reference's GFI exists for arbitrary differentiable models
(modppl/src/gfi.rs:49-92), not just the conjugate Gaussian zoo — this GLM
is the canonical member of that class: standard-normal prior over the
weights (one ``iid`` plate address), Bernoulli likelihood through a
numerically-stable log-sigmoid ``factor``. The unconstrained log-joint is
smooth, unimodal and genuinely non-quadratic; HMC runs the generic pooled
path (inference/hmc._pooled_chains) whose throughput the
``hmc_nonquad_ess_per_s_1chip`` bench leg records.

Vectorized shape: vmapped over chains, the model's hot op is a
(chains, dim) x (dim, n_data) matmul in both the forward and gradient
passes — one batched product, not scalar sites.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.dists import normal
from modppl_tpu.dists.iid import iid
from modppl_tpu.modeling import gen


def make_logreg(dim):
    """Model over args (X (n, dim), ys (n,)) with latent address "w"."""
    w_dist = iid(normal, dim)

    @gen
    def logreg(h, X, ys):
        w = h.sample(w_dist, (0.0, 1.0), "w")
        logits = X @ w
        ll = jnp.sum(ys * jax.nn.log_sigmoid(logits)
                     + (1.0 - ys) * jax.nn.log_sigmoid(-logits))
        h.factor(ll, "loglik")
        return logits

    return logreg


def make_logreg_minibatch(dim, X, ys):
    """Minibatch-ready variant for subsampled-ELBO VI (inference/vi.advi
    with ``minibatch=(n, B)``): the model closes over the FULL data, takes
    a trailing ``idx`` (B,) row-index arg, and scales the batch
    log-likelihood by n/B — exactly unbiased under
    choice-with-replacement subsampling."""
    w_dist = iid(normal, dim)
    X = jnp.asarray(X)
    ys = jnp.asarray(ys)
    scale = X.shape[0]

    @gen
    def logreg_mb(h, idx):
        w = h.sample(w_dist, (0.0, 1.0), "w")
        Xb, yb = X[idx], ys[idx]
        logits = Xb @ w
        ll = jnp.sum(yb * jax.nn.log_sigmoid(logits)
                     + (1.0 - yb) * jax.nn.log_sigmoid(-logits))
        h.factor(ll * (scale / idx.shape[0]), "loglik")
        return logits

    return logreg_mb


def simulate_logreg(key, n, dim, w_true=None):
    """Draw (X, ys, w_true) with X ~ N(0, 1) features."""
    k_x, k_w, k_y = jax.random.split(key, 3)
    X = jax.random.normal(k_x, (n, dim))
    if w_true is None:
        w_true = jax.random.normal(k_w, (dim,))
    p = jax.nn.sigmoid(X @ w_true)
    ys = (jax.random.uniform(k_y, (n,)) < p).astype(jnp.float32)
    return X, ys, w_true


def map_newton(X, ys, num_iters=50):
    """Penalized-MLE (MAP) weights by Newton iteration — the oracle the
    posterior-mean test checks against (for n >> dim the posterior is
    approximately Gaussian around this mode)."""
    import numpy as np

    X = np.asarray(X, np.float64)
    ys = np.asarray(ys, np.float64)
    n, d = X.shape
    w = np.zeros(d)
    for _ in range(num_iters):
        p = 1.0 / (1.0 + np.exp(-X @ w))
        g = X.T @ (ys - p) - w            # + standard-normal prior grad
        H = -(X.T * (p * (1 - p))) @ X - np.eye(d)
        w = w - np.linalg.solve(H, g)
    return w
