"""Exact enumerative inference over finite-support discrete latents.

No reference counterpart (the reference's inference is all Monte Carlo);
this build adds it because (a) exact posteriors are the strongest test
oracle for the samplers, and (b) enumeration is embarrassingly parallel —
the whole support grid scores in one vmapped ``assess``.

Works on any GenFn: each enumerated address is constrained to every value
in its support, jointly with the observations; the fully-constrained
generate weight is the log joint (gfi.rs:87-90). Continuous latents must be
observed or enumerated on a user-supplied grid (Riemann-sum marginal).
"""


import jax
import jax.numpy as jnp

from modppl_tpu.utils import logsumexp


def support_of(dist, params):
    """Finite support of a discrete distribution, or None.

    Knows the reference's discrete families: bernoulli {False, True},
    uniform_discrete [a, b], categorical [0, k).
    """
    from modppl_tpu.dists.scalar import (
        Bernoulli,
        Categorical,
        UniformDiscrete,
    )

    params = params if isinstance(params, tuple) else (params,)
    if isinstance(dist, Bernoulli):
        return jnp.array([False, True])
    if isinstance(dist, UniformDiscrete):
        a, b = params
        return jnp.arange(int(a), int(b) + 1)
    if isinstance(dist, Categorical):
        (probs,) = params
        return jnp.arange(probs.shape[-1])
    return None


def enumerate_posterior(model, args, observed, supports):
    """Score every combination of the given latent supports exactly.

    Args:
      model: any GenFn.
      observed: constraint Trie of observations.
      supports: {addr: 1-D array of candidate values} for every latent
        address (discrete supports, or grids for continuous latents).

    Returns dict:
      addrs: tuple of enumerated addresses (iteration order of `supports`);
      grid: {addr: flat array of that address's value per combination};
      log_joint: (num_combos,) log p(latents, observations);
      log_ml: logsumexp(log_joint) — exact when supports are exhaustive;
      log_posterior: log_joint - log_ml;
      marginals: {addr: {value_index: posterior prob}} as arrays aligned
        with `supports[addr]`.
    """
    addrs = tuple(supports)
    axes = [jnp.asarray(supports[a]) for a in addrs]
    mesh = jnp.meshgrid(*axes, indexing="ij")
    flat = [m.reshape(-1) for m in mesh]

    def score(*vals):
        cons = observed.copy()
        for a, v in zip(addrs, vals):
            cons.observe(a, v)
        # fully-constrained generate: weight == log joint (gfi.rs:87-90)
        return model.assess(jax.random.PRNGKey(0), args, cons)

    log_joint = jax.vmap(score)(*flat)
    log_ml = logsumexp(log_joint)
    log_post = log_joint - log_ml

    post = jnp.exp(log_post)
    shape = tuple(len(ax) for ax in axes)
    post_grid = post.reshape(shape)
    marginals = {}
    for i, a in enumerate(addrs):
        other = tuple(j for j in range(len(addrs)) if j != i)
        marginals[a] = jnp.sum(post_grid, axis=other) if other else post_grid

    return {
        "addrs": addrs,
        "grid": dict(zip(addrs, flat)),
        "log_joint": log_joint,
        "log_ml": log_ml,
        "log_posterior": log_post,
        "marginals": marginals,
    }


def auto_supports(model, args, observed, key=None):
    """Infer finite supports for every non-observed discrete address.

    Simulates the model once to discover its address set and per-address
    distributions (recorded on trie leaves), then maps each non-observed
    discrete address to its support. Raises if a non-observed address has
    no finite support (enumerate those via an explicit grid, or observe
    them). Only valid for models whose address structure and distribution
    params do not depend on the enumerated values.
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    trace, _ = model.generate(key, args, observed.copy())
    sup = {}
    for addr in trace.data.addresses():
        if observed.search(addr) is not None:
            continue
        node = trace.data.search(addr)
        if node.dist is None:
            continue  # sub-genfn retv, not a choice
        # params aren't stored; support_of needs them — recover for the
        # param-free cases (bernoulli); others need explicit supports.
        try:
            s = support_of(node.dist, ())
        except (ValueError, TypeError):
            s = None
        if s is None:
            raise ValueError(
                f'enumerate: address "{addr}" (dist {node.dist!r}) has no '
                "inferable finite support — pass it in `supports` explicitly")
        sup[addr] = s
    return sup
