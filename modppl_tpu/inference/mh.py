"""Metropolis-Hastings kernels.

Reference parity: ``metropolis_hastings``/``mh`` (modppl/src/inference/mh.rs:9-50)
and ``regenerative_metropolis_hastings``/``regen_mh`` (mh.rs:54-76).

The proposal is itself a GenFn over the same Data type whose args are
``(prev_trace, *proposal_args)`` and whose return value is ignored — the
Functional replacement for the reference's ``Weak<Trace>`` first-argument
convention (mh.rs:12): traces are immutable pytrees, so the previous trace is
passed by value.

These generic kernels run eagerly over any GenFn (including dynamic-structure
models — trans-dimensional MCMC works exactly as in the reference). For
compiled many-chain MCMC on static models, see
``modppl_tpu.inference.mcmc`` (scan over iterations, vmap over chains).
"""

import jax
import jax.numpy as jnp

from modppl_tpu.core.gfi import ArgDiff


def metropolis_hastings(key, model, trace, proposal, proposal_args=()):
    """One proposal-based MH transition; returns (trace, accepted).

    Flow (mh.rs:15-40): propose forward choices → model.update with them →
    assess the discard under the backward proposal → accept iff
    ln u < weight - fwd_weight + bwd_weight.
    """
    k_fwd, k_upd, k_bwd, k_acc = jax.random.split(key, 4)
    proposal_args = proposal_args if isinstance(proposal_args, tuple) else (proposal_args,)

    fwd_choices, fwd_weight = proposal.propose(k_fwd, (trace,) + proposal_args)
    new_trace, discard, weight = model.update(
        k_upd, trace, trace.args, ArgDiff.NO_CHANGE, fwd_choices)
    bwd_weight = proposal.assess(k_bwd, (new_trace,) + proposal_args, discard)

    alpha = weight - fwd_weight + bwd_weight
    accept = jnp.log(jax.random.uniform(k_acc, ())) < alpha
    if accept:
        return new_trace, True
    return trace, False


mh = metropolis_hastings


def regenerative_metropolis_hastings(key, model, trace, selection):
    """One regenerative MH transition over a masked subset (mh.rs:54-67)."""
    k_regen, k_acc = jax.random.split(key)
    new_trace, weight = model.regenerate(
        k_regen, trace, trace.args, ArgDiff.NO_CHANGE, selection)
    accept = jnp.log(jax.random.uniform(k_acc, ())) < weight
    if accept:
        return new_trace, True
    return trace, False


regen_mh = regenerative_metropolis_hastings
