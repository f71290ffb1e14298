"""Map: the vmapped-plate combinator over a generative function.

The genfn-level counterpart of the ``iid`` distribution plate: applies a
kernel generative function independently across the leading axis of its
arguments, with all four GFI operations vectorized by ``vmap`` — one
batched sub-trace instead of N scalar addresses (the vectorized replacement
for the reference's ``format!``-indexed loops over sub-calls).

    plate = Map(obs_point_model)
    ys = h.trace(plate, (slopes, xs), "ys")   # leaves carry a leading axis

Constraints/discards carry the same leading axis on every leaf. Weights and
logjp are summed across the plate.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.core.gfi import GenFn, Trace


def _leading_dim(args):
    leaves = jax.tree_util.tree_leaves(args)
    if not leaves:
        raise ValueError("Map: args must contain at least one array leaf")
    return leaves[0].shape[0]


def _batch_trie(trie, n):
    """Copy a constraint/data trie with every leaf logp broadcast to (n,)
    so the whole trie vmaps along axis 0 (values must already carry the
    leading plate axis)."""
    t = trie.copy()

    def walk(node):
        # every node's logp participates in the pytree flatten, including
        # interior nodes' structural zeros — broadcast them all
        node.logp = jnp.zeros((n,)) + node.logp
        for sub in node.children.values():
            walk(sub)

    walk(t)
    return t


class Map(GenFn):
    """Apply `kernel` independently across the leading axis of args."""

    def __init__(self, kernel):
        self.kernel = kernel

    def __repr__(self):
        return f"Map({self.kernel!r})"

    def simulate(self, key, args):
        n = _leading_dim(args)
        keys = jax.random.split(key, n)
        traces = jax.vmap(self.kernel.simulate)(keys, args)
        return Trace(args, traces.data, traces.retv, jnp.sum(traces.logjp))

    def generate(self, key, args, constraints):
        n = _leading_dim(args)
        keys = jax.random.split(key, n)
        traces, ws = jax.vmap(self.kernel.generate)(
            keys, args, _batch_trie(constraints, n))
        return Trace(args, traces.data, traces.retv,
                     jnp.sum(traces.logjp)), jnp.sum(ws)

    def update(self, key, trace, args, argdiff, constraints):
        n = _leading_dim(args)
        keys = jax.random.split(key, n)
        trace_in = Trace(args, trace.data, trace.retv, jnp.zeros((n,)))
        traces, discard, ws = jax.vmap(
            lambda k, tr, a, c: self.kernel.update(k, tr, a, argdiff, c)
        )(keys, trace_in, args, _batch_trie(constraints, n))
        return Trace(args, traces.data, traces.retv,
                     jnp.sum(traces.logjp)), discard, jnp.sum(ws)

    def regenerate(self, key, trace, args, argdiff, selection):
        n = _leading_dim(args)
        keys = jax.random.split(key, n)
        trace_in = Trace(args, trace.data, trace.retv, jnp.zeros((n,)))
        traces, ws = jax.vmap(
            lambda k, tr, a: self.kernel.regenerate(k, tr, a, argdiff,
                                                    selection)
        )(keys, trace_in, args)
        return Trace(args, traces.data, traces.retv,
                     jnp.sum(traces.logjp)), jnp.sum(ws)
