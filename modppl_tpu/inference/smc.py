"""Sequential Monte Carlo: the ParticleSystem engine.

Reference parity: ``ParticleSystem`` (modppl/src/inference/particle_filter.rs,
itself adapted from GenTL's particle_filter.h) — generic over any GenFn with
a time parameter as the first input argument:

- ``init_step``: N × generate((1, args), constraints)   (particle_filter.rs:59-70)
- ``step``: per-particle update(trace, (t+1, args), EXTEND, constraints)
  (particle_filter.rs:73-95)
- ``effective_sample_size`` = exp(-logsumexp(2 · log norm w)) (98-100)
- ``resample``: normalize → log_ml += logsumexp - ln N → multinomial parents
  → clone selected traces, zero weights (103-116)
- ``log_marginal_likelihood_estimate`` (119-121)

This class preserves the reference's per-particle loop semantics for *any*
GenFn (trie models, hand-coded tuple-buffer models, Unfold). The compiled
path is ``modppl_tpu.inference.vsmc`` (vmap over particles, lax.scan
over time, index-gather resampling).
"""

import jax
import jax.numpy as jnp

from modppl_tpu.core.gfi import ArgDiff
from modppl_tpu.utils import effective_sample_size_from_log_weights, logsumexp


class ParticleSystem:
    """Basic particle filter over a GenFn with args ``(t, args)``."""

    def __init__(self, model, num_particles, key):
        self.num_particles = num_particles
        self.model = model
        self.key = key
        self.traces = []
        self.log_weights = jnp.zeros(num_particles)
        self.log_ml_estimate = 0.0

    def _next_key(self, n=1):
        self.key, *keys = jax.random.split(self.key, n + 1)
        return keys if n > 1 else keys[0]

    def init_step(self, args, constraints):
        """Initialize with N traces from generate((1, args), constraints)."""
        keys = self._next_key(self.num_particles)
        log_weights = []
        for i in range(self.num_particles):
            trace, log_weight = self.model.generate(keys[i], (1, args), constraints)
            self.traces.append(trace)
            log_weights.append(jnp.asarray(log_weight))
        self.log_weights = jnp.stack(log_weights)

    def step(self, constraints):
        """Extend every particle from t to t+1 under new constraints."""
        keys = self._next_key(self.num_particles)
        new_traces, increments = [], []
        for i, trace in enumerate(self.traces):
            t, args = trace.args
            new_trace, _, log_weight = self.model.update(
                keys[i], trace, (t + 1, args), ArgDiff.EXTEND, constraints)
            new_traces.append(new_trace)
            increments.append(jnp.asarray(log_weight))
        self.traces = new_traces
        self.log_weights = self.log_weights + jnp.stack(increments)
        return self

    def _log_normalized_weights(self):
        return self.log_weights - logsumexp(self.log_weights)

    def effective_sample_size(self):
        return effective_sample_size_from_log_weights(self._log_normalized_weights())

    def resample(self):
        """Multinomial resampling; returns the log total weight."""
        log_total_weight = logsumexp(self.log_weights)
        log_normalized = self.log_weights - log_total_weight
        self.log_ml_estimate = self.log_ml_estimate + log_total_weight \
            - jnp.log(float(self.num_particles))
        k = self._next_key()
        parents = jax.random.categorical(
            k, log_normalized, shape=(self.num_particles,))
        # EAGER-TIER ONLY: `int(p)` forces a device->host sync per resample
        # (one transfer of `parents`, then N Python-level clones). This
        # tier exists for reference parity (particle_filter.rs:103-116) at
        # small N; at scale use the compiled tiers' device-side gather
        # (inference/vsmc.py, parallel/sharded_smc.py).
        self.traces = [self.traces[int(p)].copy() for p in parents]
        self.log_weights = jnp.zeros(self.num_particles)
        return log_total_weight

    def log_marginal_likelihood_estimate(self):
        return self.log_ml_estimate + logsumexp(self.log_weights) \
            - jnp.log(float(self.num_particles))
