"""Structure combinators for the compiled tier.

The reference's models branch on sampled values with plain Rust ``if``
(e.g. the bernoulli gate at modppl/tests/dyngenfns/hierarchical.rs:35-45)
— fine eagerly, impossible under XLA tracing. The compiled-tier idioms:

1. **Saturated form** (preferred for gated regression-style models): sample
   every branch's parameters unconditionally and gate their *effect* with
   ``jnp.where`` — see models/hierarchical_static.py. Exact posterior on the
   active parameters; extra variables integrate out as prior-scored
   auxiliaries.

2. **Cond / Switch combinators** (this module): trace *all* branches under
   per-branch namespaces and select the return value by the (traced)
   predicate. The trace's logjp scores every branch under its own prior —
   the inactive branches are proper auxiliary variables, so importance
   weights and MH acceptance ratios remain exact for queries on the active
   branch. All four GFI operations come for free because the combinator is
   itself a @gen function.

Both idioms trade a constant factor of compute (evaluating all branches)
for static shapes — the right trade on a SIMD accelerator, where a
divergent branch would cost the same anyway and dynamic shapes would forbid
fusion.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.modeling.gen import gen


def tree_select(pred, a, b):
    """Leafwise where(pred, a, b) over two same-structure pytrees."""
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def Cond(true_gen, false_gen, namespaces=("true", "false")):
    """Two-way stochastic branch: traces both, selects retv by predicate.

    Usage: ``h.trace(Cond(lin, quad), (pred, args), "branch")`` — the
    sub-trace holds ``branch/true/...`` and ``branch/false/...``; retv
    structures of the two branches must match.
    """
    t_ns, f_ns = namespaces

    @gen
    def cond_fn(h, pred, args=()):
        rt = h.trace(true_gen, args, t_ns)
        rf = h.trace(false_gen, args, f_ns)
        return tree_select(pred, rt, rf)

    cond_fn.__name__ = f"Cond({getattr(true_gen, '__name__', '?')}, " \
                       f"{getattr(false_gen, '__name__', '?')})"
    return cond_fn


def Switch(*branch_gens):
    """N-way stochastic branch: traces all branches, selects retv by index.

    Usage: ``h.trace(Switch(g0, g1, g2), (idx, args), "k")``; sub-namespaces
    are "0", "1", ... and retv structures must match across branches.
    """

    @gen
    def switch_fn(h, index, args=()):
        retvs = [h.trace(g, args, str(i)) for i, g in enumerate(branch_gens)]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *retvs)
        return jax.tree_util.tree_map(
            lambda s: jnp.take(s, index, axis=0), stacked)

    switch_fn.__name__ = f"Switch({len(branch_gens)})"
    return switch_fn
