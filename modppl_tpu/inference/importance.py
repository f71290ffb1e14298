"""Importance sampling and importance resampling.

Reference parity: ``importance_sampling`` (modppl/src/inference/importance.rs:12-28)
and ``importance_resampling`` (importance.rs:37-51).

Vectorized shape: the reference's hot loop of N independent ``generate`` calls
(importance.rs:18-20) becomes one ``vmap``'d generate over a particle axis —
a single XLA program evaluating all particles' log-joints —
followed by a fused logsumexp. Models whose generate cannot be traced
(data-dependent Python control flow) fall back to an eager loop with
identical semantics via ``vectorized=False``.

Returned traces are a *batched* Trace pytree (every leaf has a leading
particle axis) in vectorized mode — the batched replacement for ``Vec<Trace>``;
use ``tree_index`` to extract single traces.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.utils import logsumexp


def tree_index(tree, i):
    """Extract element `i` of a batched pytree (e.g. one trace of a batch)."""
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def importance_sampling(key, model, model_args, constraints, num_samples,
                        vectorized=True):
    """N-sample importance sampling with the internal proposal.

    Returns (traces, log_normalized_weights, log_ml_estimate)
    (importance.rs:21-27): log_ml = logsumexp(w) - ln N.
    """
    keys = jax.random.split(key, num_samples)
    if vectorized:
        traces, log_weights = jax.vmap(
            lambda k: model.generate(k, model_args, constraints))(keys)
    else:
        out = [model.generate(k, model_args, constraints) for k in keys]
        traces = [t for t, _ in out]
        log_weights = jnp.stack([jnp.asarray(w) for _, w in out])
    log_total_weight = logsumexp(log_weights)
    log_ml_estimate = log_total_weight - jnp.log(float(num_samples))
    log_normalized_weights = log_weights - log_total_weight
    return traces, log_normalized_weights, log_ml_estimate


def importance_resampling(key, model, model_args, constraints, num_samples,
                          num_ret_samples, vectorized=True):
    """Importance sampling + categorical resampling of trace indices.

    Returns (traces, resampled_indices, log_ml_estimate) (importance.rs:37-51).
    """
    k_is, k_res = jax.random.split(key)
    traces, log_normalized_weights, log_ml_estimate = importance_sampling(
        k_is, model, model_args, constraints, num_samples, vectorized=vectorized)
    idx_keys = jax.random.split(k_res, num_ret_samples)
    resampled_indices = jax.vmap(
        lambda k: jax.random.categorical(k, log_normalized_weights))(idx_keys)
    return traces, resampled_indices, log_ml_estimate
