"""Distribution protocol and the u01 primitive.

JAX counterpart of ``Distribution<T,U>`` (modppl/src/modeling/dists/
distribution.rs:10-17) and ``u01`` (distribution.rs:5-7).

``logpdf(x, params)`` is pure jnp (batched via vmap, fused into the traced
log-joint); ``sample(key, params)`` uses counter-based ``jax.random``
samplers in place of the reference's ``ThreadRng`` — required for
reproducibility under vmap/shard_map.

Parameter conventions match the reference exactly (§2 of SURVEY.md):
std-dev normal, shape/scale gamma, k-failures geometric, probs-vector
categorical, inclusive uniform bounds.
"""

import jax
import jax.numpy as jnp


def u01(key, shape=()):
    """Uniform [0, 1) sample — the primitive the reference builds samplers on
    (distribution.rs:5-7)."""
    return jax.random.uniform(key, shape)


def as_param_tuple(params):
    """Normalize params: scalars (e.g. bernoulli's bare p) become 1-tuples."""
    if isinstance(params, tuple):
        return params
    return (params,)


class Distribution:
    """A sampling distribution with an analytic log-density.

    Subclasses implement ``_logpdf(x, *params)`` and ``_sample(key, *params)``;
    the public API accepts reference-style packed params (tuple, or a bare
    scalar for single-parameter distributions).
    """

    #: True if samples live in a discrete space (no HMC gradient flow).
    is_discrete = False

    #: Support of the distribution: "real" | "positive" | "unit_interval" |
    #: "discrete" | "other". Drives default unconstraining bijectors in
    #: gradient-based inference (inference/transforms.py).
    support = "real"

    def logpdf(self, x, params):
        """log p(x; params) as a traced jnp scalar (distribution.rs:13)."""
        return self._logpdf(x, *as_param_tuple(params))

    def sample(self, key, params):
        """x ~ p(.; params) using a counter-based PRNG key (distribution.rs:16)."""
        return self._sample(key, *as_param_tuple(params))

    def sample_batch(self, key, shape, params):
        """`shape` iid draws from ONE key's counter stream.

        The fast path for plated/batched-particle sampling: a single
        threefry stream covers the whole batch instead of per-element
        `split` + `fold_in` (3x fewer threefry blocks per draw at 10^6
        particles). Scalar distributions override `_sample_batch` with
        jax.random's natively-batched samplers; the default falls back to
        split + vmap (identical distribution, different stream).
        """
        return self._sample_batch(key, shape, *as_param_tuple(params))

    # alias matching the reference's method name (`random`)
    def random(self, key, params):
        return self.sample(key, params)

    def _logpdf(self, x, *params):
        raise NotImplementedError

    def _sample(self, key, *params):
        raise NotImplementedError

    def _sample_batch(self, key, shape, *params):
        # generic fallback: split + vmap (unbatched params only)
        assert len(shape) == 1, "generic sample_batch supports 1-D shapes"
        keys = jax.random.split(key, shape[0])
        return jax.vmap(lambda k: self._sample(k, *params))(keys)

    def __repr__(self):
        return type(self).__name__


def _f(x):
    """Promote to the default floating dtype (f64 when x64 is enabled)."""
    return jnp.asarray(x, dtype=jnp.result_type(float, x))
