"""Compiled MCMC: lax.scan over iterations, vmap over chains.

Compiled execution of the reference's MH kernels (modppl/src/inference/
mh.rs): the single-chain Rust loops of modppl/tests/mh.rs become one XLA
program — iterations under ``lax.scan``, chains under ``vmap`` — with the
accept/reject clone (mh.rs:15,35-39) replaced by a ``where``-select over the
trace pytree (static-structure models only; dynamic-structure /
trans-dimensional chains use the eager kernels in inference/mh.py).
"""

import jax
import jax.numpy as jnp

from modppl_tpu.core.gfi import ArgDiff


def tree_select(pred, a, b):
    """Select a (pred) or b, leafwise, over two same-structure pytrees."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b)


def mh_kernel(model, proposal, proposal_args=()):
    """One compiled proposal-MH transition: (key, trace) -> (trace, accepted).

    Same flow as mh.rs:15-40 with select-based accept.
    """
    proposal_args = proposal_args if isinstance(proposal_args, tuple) else (proposal_args,)

    def kernel(key, trace):
        k_fwd, k_upd, k_bwd, k_acc = jax.random.split(key, 4)
        fwd_choices, fwd_weight = proposal.propose(k_fwd, (trace,) + proposal_args)
        new_trace, discard, weight = model.update(
            k_upd, trace, trace.args, ArgDiff.NO_CHANGE, fwd_choices)
        bwd_weight = proposal.assess(k_bwd, (new_trace,) + proposal_args, discard)
        alpha = weight - fwd_weight + bwd_weight
        accept = jnp.log(jax.random.uniform(k_acc, ())) < alpha
        return tree_select(accept, new_trace, trace), accept

    return kernel


def regen_mh_kernel(model, selection):
    """One compiled regenerative-MH transition (mh.rs:54-67)."""

    def kernel(key, trace):
        k_regen, k_acc = jax.random.split(key)
        new_trace, weight = model.regenerate(
            k_regen, trace, trace.args, ArgDiff.NO_CHANGE, selection)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < weight
        return tree_select(accept, new_trace, trace), accept

    return kernel


def mcmc_chain(key, kernel, trace0, num_iters, extract=None):
    """Scan `kernel` for num_iters; returns (final_trace, samples, accepts).

    `extract(trace)` selects what to record per iteration (defaults to
    nothing, keeping memory O(1) in chain length).
    """

    def body(trace, k):
        trace, accept = kernel(k, trace)
        out = (extract(trace) if extract is not None else None, accept)
        return trace, out

    keys = jax.random.split(key, num_iters)
    final, (samples, accepts) = jax.lax.scan(body, trace0, keys)
    return final, samples, accepts


def mcmc_chains(key, kernel, traces0, num_iters, num_chains, extract=None):
    """vmap of mcmc_chain over a batched initial-trace pytree.

    This is particle/chain data-parallelism (SURVEY.md §2b item 1): the
    chains axis shards over the device mesh with pjit/shard_map.
    """
    keys = jax.random.split(key, num_chains)
    return jax.vmap(
        lambda k, tr: mcmc_chain(k, kernel, tr, num_iters, extract)
    )(keys, traces0)
