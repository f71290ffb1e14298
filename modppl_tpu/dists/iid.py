"""IID ("plate") distribution wrapper: one batched address per vector of draws.

Vectorized replacement for the reference's per-index address loops
(e.g. ``format!("(y, {})", i)`` at modppl/tests/dyngenfns/hierarchical.rs:38,43
and obs_model's per-i addresses at simple.rs:11-17): instead of N scalar trie
leaves, a single leaf holds the whole vector and its summed log-density —
the elementwise logpdf fuses into one kernel and the trace stays small.

Works through every GFI mode unchanged because it is just a Distribution:
``h.sample(iid(normal, n), params, "ys")`` samples shape (n, ...) values with
``logpdf = sum_i base.logpdf(x_i, params_i)`` (params broadcast or carry a
leading batch axis).
"""

import jax
import jax.numpy as jnp

from modppl_tpu.dists.base import Distribution, as_param_tuple


class IID(Distribution):
    """n independent draws from `base` as one vector-valued random variable."""

    def __init__(self, base, n):
        self.base = base
        self.n = n
        self.is_discrete = base.is_discrete
        self.support = base.support

    def logpdf(self, x, params):
        params = as_param_tuple(params)
        lp = jax.vmap(
            lambda xi, *ps: self.base._logpdf(xi, *ps),
            in_axes=(0,) + tuple(0 if _has_batch_axis(p, self.n) else None
                                 for p in params),
        )(x, *params)
        return jnp.sum(lp)

    def sample(self, key, params):
        params = as_param_tuple(params)
        if all(getattr(p, "ndim", 0) == 0 or isinstance(p, (int, float))
               for p in params):
            # scalar params: one threefry stream for the whole plate (the
            # fast path — no per-element split)
            return self.base.sample_batch(key, (self.n,), params)
        keys = jax.random.split(key, self.n)
        return jax.vmap(
            lambda k, *ps: self.base._sample(k, *ps),
            in_axes=(0,) + tuple(0 if _has_batch_axis(p, self.n) else None
                                 for p in params),
        )(keys, *params)

    def __repr__(self):
        return f"IID({self.base!r}, n={self.n})"


def _has_batch_axis(p, n):
    """Heuristic: a param participates in the plate iff its leading axis is n."""
    return hasattr(p, "shape") and len(getattr(p, "shape", ())) >= 1 \
        and p.shape[0] == n


def iid(base, n):
    """Plate constructor: ``iid(normal, 11)`` ~ 11 independent normals."""
    return IID(base, n)
