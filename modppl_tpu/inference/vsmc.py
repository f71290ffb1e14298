"""Compiled vectorized SMC: vmap over particles, lax.scan over time.

This is the compiled execution of the reference's particle filter
(modppl/src/inference/particle_filter.rs + dynunfold.rs): the per-particle
Rust loops (particle_filter.rs:65-95) become one ``vmap``'d generate per
step, the time loop becomes ``lax.scan``, and resampling becomes a
cumsum/searchsorted + index-gather (parallel/resample.py). The whole filter
— T steps × N particles — compiles to a single XLA program.

Model form: a :class:`ScanKernel` pair (init_gen, step_gen) with *static*
trace structure — the compiled counterpart of the Unfold combinator's
``t == 0`` branch (modppl/tests/dyngenfns/unfold.rs:18-28), split into two
generative functions because XLA control flow cannot branch on a traced
``t`` with different address sets.

Semantics preserved: per-step weight accumulation, ESS
(particle_filter.rs:98-100), log-ML bookkeeping (105, 119-121), and the
EXTEND-style O(1)-per-step extension (each scan step only touches the new
timestep's choices).
"""

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from modppl_tpu.parallel.resample import (
    RESAMPLERS,
    gather_particles,
)
from modppl_tpu.utils import effective_sample_size_from_log_weights, logsumexp


@dataclass(frozen=True)
class ScanKernel:
    """A state-space model as (init, step) generative functions.

    - ``init``: Gen over args ``(state0,)`` returning the initial state.
    - ``step``: Gen over args ``(t, state)`` (``t`` traced, >= 1) returning
      the next state. Must have static trace structure.
    """

    init: Any
    step: Any


@jax.tree_util.register_pytree_node_class
@dataclass
class SMCState:
    """Carry of the compiled filter: one pytree, shardable over the mesh."""

    key: Any
    state: Any            # per-particle latent state, leading axis N
    log_weights: Any      # (N,)
    log_ml: Any           # scalar
    t: Any                # scalar int

    def tree_flatten(self):
        return (self.key, self.state, self.log_weights, self.log_ml, self.t), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


def smc_init(key, kernel, state0, constraints, num_particles):
    """Initialize N particles: vmapped init.generate (particle_filter.rs:59-70)."""
    k_sim, k_carry = jax.random.split(key)
    keys = jax.random.split(k_sim, num_particles)
    with jax.named_scope("smc.init"):
        traces, log_weights = jax.vmap(
            lambda k: kernel.init.generate(k, (state0,), constraints))(keys)
    state = traces.retv
    return SMCState(k_carry, state, log_weights,
                    jnp.zeros((), log_weights.dtype),
                    jnp.ones((), jnp.int32)), traces


def _resample(key, s, resampler, ess_threshold, num_particles):
    """Conditional resampling (compiled; no host sync).

    Uses lax.cond so that on non-resample steps the ancestor computation and
    gather are actually *skipped* at runtime (a where-select would pay the
    scatter, cumsum and gather every step).
    """
    log_total = logsumexp(s.log_weights)
    log_norm = s.log_weights - log_total
    ess = effective_sample_size_from_log_weights(log_norm)
    do = ess < ess_threshold * num_particles

    def resample_branch(_):
        parents = resampler(key, log_norm)
        state = gather_particles(s.state, parents)
        log_weights = jnp.zeros_like(s.log_weights)
        log_ml = s.log_ml + log_total - jnp.log(float(num_particles))
        return state, log_weights, log_ml, parents

    def keep_branch(_):
        return (s.state, s.log_weights, s.log_ml,
                jnp.arange(num_particles, dtype=jnp.int32))

    state, log_weights, log_ml, parents = jax.lax.cond(
        do, resample_branch, keep_branch, None)
    return SMCState(s.key, state, log_weights, log_ml, s.t), parents, ess, do


def _rejuvenate(key, traces, kernel, selection, num_moves):
    """Resample-move rejuvenation (Gilks & Berzuini): `num_moves` compiled
    regenerative-MH transitions per particle on the current step's choices,
    targeting p(choices_t | prev_state, obs_t). Applied after weighting, so
    the log-ML estimate is untouched."""
    from modppl_tpu.core.gfi import ArgDiff
    from modppl_tpu.inference.mcmc import tree_select

    # a selection outside the kernel's address set would silently no-op
    missing = [a for a in selection.leaf_addresses()
               if traces.data.search(a) is None]
    if missing:
        raise ValueError(
            f"rejuvenation: selection addresses {missing} not in the step "
            f"kernel's trace (has {traces.data.addresses()})")

    def one_move(k, tr):
        k_regen, k_acc = jax.random.split(k)
        new_tr, w = kernel.step.regenerate(
            k_regen, tr, tr.args, ArgDiff.NO_CHANGE, selection)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < w
        return tree_select(accept, new_tr, tr)

    def moves(k, tr):
        for r in range(num_moves):
            tr = one_move(jax.random.fold_in(k, r), tr)
        return tr

    n = traces.logjp.shape[0]
    keys = jax.random.split(key, n)
    return jax.vmap(moves)(keys, traces)


def smc_step(s, kernel, constraints_t, num_particles, resampler,
             ess_threshold, store_traces=True, rejuvenation=None,
             proposal=None, proposal_params=None):
    """One filter step: (maybe) resample, extend every particle, optionally
    rejuvenate (resample-move).

    With ``proposal`` (a Gen over args ``(t, state, constraints_t)``), the
    step is a *guided* filter: the proposal's choices constrain the kernel
    and the weight increment is ``model_weight - proposal_logjp`` — the
    general SMC proposal identity. ``proposal=None`` is the bootstrap
    filter (the reference's only mode, particle_filter.rs:73-95).
    """
    key, k_res, k_gen, k_rej = jax.random.split(s.key, 4)
    with jax.named_scope("smc.resample"):
        s, parents, ess, resampled = _resample(
            k_res, s, resampler, ess_threshold, num_particles)
    keys = jax.random.split(k_gen, num_particles)
    with jax.named_scope("smc.extend"):
        if proposal is None:
            traces, w = jax.vmap(
                lambda k, st: kernel.step.generate(k, (s.t, st), constraints_t)
            )(keys, s.state)
        else:
            def guided(k, st):
                k_p, k_m = jax.random.split(k)
                pargs = ((s.t, st, constraints_t) if proposal_params is None
                         else (s.t, st, constraints_t, proposal_params))
                pchoices, plogjp = proposal.propose(k_p, pargs)
                cons = constraints_t.copy()
                cons.merge(pchoices)
                tr, mw = kernel.step.generate(k_m, (s.t, st), cons)
                return tr, mw - plogjp

            traces, w = jax.vmap(guided)(keys, s.state)
    if rejuvenation is not None:
        selection, num_moves = rejuvenation
        with jax.named_scope("smc.rejuvenate"):
            traces = _rejuvenate(k_rej, traces, kernel, selection, num_moves)
    new = SMCState(key, traces.retv, s.log_weights + w, s.log_ml, s.t + 1)
    return new, (traces if store_traces else None, parents, ess, resampled)


# --------------------------------------------------------------------------
# Batched-particle tier: the particle axis as an array axis, not a vmap
# --------------------------------------------------------------------------

def batched_smc_init(key, kernel, state0, constraints, num_particles):
    """Initialize via ONE generate over a batch-aware init model.

    ``kernel.init`` receives args ``(state0, n)`` and must return a state
    with leading axis n, sampling latents with ``plate(dist, n)`` addresses
    (one threefry stream per address — no per-particle key splitting).
    The generate weight must come out per-particle ``(n,)``: constrained
    (observation) addresses score elementwise by broadcasting.
    """
    k_gen, k_carry = jax.random.split(key)
    with jax.named_scope("smc.init"):
        trace, log_weights = kernel.init.generate(
            k_gen, (state0, num_particles), constraints)
    return SMCState(k_carry, trace.retv, log_weights,
                    jnp.zeros((), log_weights.dtype),
                    jnp.ones((), jnp.int32)), trace


def batched_smc_step(s, kernel, constraints_t, num_particles, resampler,
                     ess_threshold, proposal=None, proposal_params=None,
                     rejuvenation=None, rejuvenation_kernel=None):
    """One batched filter step: (maybe) resample, ONE generate to extend,
    optionally guided and/or rejuvenated.

    ``proposal`` (batched-tier): an object with ``propose(key, (t, state,
    constraints_t[, params]), n) -> (choices, logjp)`` returning
    per-particle batched choices — modeling/autobatch.AutoBatchedPropose
    wraps an ordinary per-particle ``@gen`` proposal into this form. The
    weight increment is ``model_weight - proposal_logjp`` (the general SMC
    proposal identity), matching the vmapped tier (smc_step).

    ``rejuvenation``: optional (Selection, num_moves) resample-move pass;
    ``rejuvenation_kernel`` is the PER-PARTICLE step Gen whose regenerate
    drives the moves (the auto-batch wrapper's ``.inner`` — regeneration
    is inherently per-particle, so it vmaps the eager kernel).

    RNG stream: the legacy 3-way split of ``s.key`` is preserved when
    ``rejuvenation is None`` (ADVICE r4 — a round-4 unconditional 4-way
    split silently changed every batched filter's bitwise stream); the
    rejuvenation key is derived separately via fold_in only when used."""
    key, k_res, k_gen = jax.random.split(s.key, 3)
    k_rej = (jax.random.fold_in(s.key, 3) if rejuvenation is not None
             else None)
    with jax.named_scope("smc.resample"):
        s, parents, ess, resampled = _resample(
            k_res, s, resampler, ess_threshold, num_particles)
    with jax.named_scope("smc.extend"):
        if proposal is None:
            trace, w = kernel.step.generate(k_gen, (s.t, s.state),
                                            constraints_t)
        else:
            k_prop, k_mod = jax.random.split(k_gen)
            pargs = ((s.t, s.state, constraints_t) if proposal_params is None
                     else (s.t, s.state, constraints_t, proposal_params))
            pchoices, plogjp = proposal.propose(k_prop, pargs,
                                                num_particles)
            # observations broadcast to the particle axis, then merged
            # with the per-particle proposed choices -> fully batched
            # constraints for the per-lane-constrained generate
            cons = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(
                    x, (num_particles,) + jnp.shape(x)),
                constraints_t)
            cons.merge(pchoices)
            trace, mw = kernel.step.generate_constrained_batched(
                k_mod, (s.t, s.state), cons)
            w = mw - plogjp
    if rejuvenation is not None:
        selection, num_moves = rejuvenation
        inner = ScanKernel(None, rejuvenation_kernel)
        with jax.named_scope("smc.rejuvenate"):
            trace = _rejuvenate(k_rej, trace, inner, selection, num_moves)
    new = SMCState(key, trace.retv, s.log_weights + w, s.log_ml, s.t + 1)
    return new, (parents, ess, resampled)


@partial(jax.jit, static_argnames=(
    "kernel", "num_particles", "resampling", "ess_threshold", "auto_batch",
    "proposal", "rejuvenation"))
def batched_particle_filter(key, kernel, state0, init_constraints,
                            step_constraints, num_particles,
                            resampling="systematic", ess_threshold=1.0,
                            auto_batch=False, proposal=None,
                            proposal_params=None, rejuvenation=None):
    """Compiled filter over a *batch-aware* ScanKernel.

    Unlike :func:`particle_filter` (which vmaps a per-particle kernel), the
    models here treat the particle axis as an ordinary array axis: latents
    are sampled from ONE counter stream per address, constrained scores
    broadcast to per-particle ``(n,)`` weights, and no per-particle keys
    are ever split — ~3x fewer threefry blocks per step, and a smaller
    HLO.

    Pass ``auto_batch=True`` to hand in an ORDINARY per-particle
    ScanKernel (e.g. models/spiral.py::spiral_scan_kernel): the kernel is
    wrapped with modeling/autobatch.auto_batch_scan_kernel, which runs the
    body per-particle under vmap while hoisting each address's draws into
    a shared plate stream — no hand-written batch-aware model variants
    needed. With ``auto_batch=False`` the kernel must already be
    batch-aware (``plate(dist, n)`` addresses, per-particle weights).
    """
    rejuvenation_kernel = None
    if auto_batch:
        from modppl_tpu.modeling.autobatch import (
            AutoBatchedPropose,
            auto_batch_scan_kernel,
        )

        rejuvenation_kernel = kernel.step
        kernel = auto_batch_scan_kernel(kernel)
        if proposal is not None:
            proposal = AutoBatchedPropose(proposal)
    elif proposal is not None or rejuvenation is not None:
        raise ValueError(
            "batched_particle_filter: proposal/rejuvenation require "
            "auto_batch=True (the guided weights and regenerative moves "
            "are derived from the per-particle kernel)")
    resampler = RESAMPLERS[resampling]
    s, _ = batched_smc_init(key, kernel, state0, init_constraints,
                            num_particles)

    def body(carry, cons_t):
        return batched_smc_step(carry, kernel, cons_t, num_particles,
                                resampler, ess_threshold,
                                proposal=proposal,
                                proposal_params=proposal_params,
                                rejuvenation=rejuvenation,
                                rejuvenation_kernel=rejuvenation_kernel)

    s, (parents, ess, resampled) = jax.lax.scan(body, s, step_constraints)
    log_ml = s.log_ml + logsumexp(s.log_weights) - jnp.log(float(num_particles))
    return {
        "state": s.state,
        "log_weights": s.log_weights,
        "log_ml": log_ml,
        "ancestors": parents,
        "ess": ess,
        "resampled": resampled,
    }


@partial(jax.jit, static_argnames=(
    "kernel", "num_particles", "resampling", "ess_threshold",
    "store_traces", "rejuvenation", "proposal"))
def particle_filter(key, kernel, state0, init_constraints, step_constraints,
                    num_particles, resampling="systematic",
                    ess_threshold=1.0, store_traces=True, rejuvenation=None,
                    proposal=None, proposal_params=None):
    """Run the full compiled filter.

    Args:
      kernel: ScanKernel (hashable — pass module-level Gen objects).
      state0: initial latent state (unbatched).
      init_constraints: constraint Trie for the t=0 init model.
      step_constraints: constraint Trie whose leaves carry a leading time
        axis of length T-1 (one slice per step t=1..T-1).
      num_particles: N.
      resampling: 'systematic' | 'multinomial'.
      ess_threshold: resample when ESS < threshold*N (1.0 = always, matching
        the reference tests' resample-every-step usage).
      store_traces: keep the per-step batched choice tries in the output
        (O(T*N) memory). Disable for long filters / throughput runs where
        only states, weights, ancestry and log-ML are needed.
      rejuvenation: optional (Selection, num_moves) — apply that many
        compiled regenerative-MH moves over the selected addresses of each
        particle's current step after weighting (resample-move).

    Returns a dict with final state, per-step ancestors/ESS, the batched
    per-step traces, and the log marginal likelihood estimate
    (particle_filter.rs:119-121).
    """
    resampler = RESAMPLERS[resampling]
    s, init_traces = smc_init(key, kernel, state0, init_constraints,
                              num_particles)

    def body(carry, cons_t):
        return smc_step(carry, kernel, cons_t, num_particles, resampler,
                        ess_threshold, store_traces=store_traces,
                        rejuvenation=rejuvenation, proposal=proposal,
                        proposal_params=proposal_params)

    s, (step_traces, parents, ess, resampled) = jax.lax.scan(
        body, s, step_constraints)
    log_ml = s.log_ml + logsumexp(s.log_weights) - jnp.log(float(num_particles))
    return {
        "state": s.state,
        "log_weights": s.log_weights,
        "log_ml": log_ml,
        "ancestors": parents,
        "ess": ess,
        "resampled": resampled,
        "init_traces": init_traces,
        "step_traces": step_traces,
    }
