"""Warmup adaptation: dual-averaging step size + windowed mass estimation.

Stan-style schedule shared by HMC and NUTS:

  [ fast: step size only | slow windows: 25, 50, 100, ... (mass) | fast ]

Each slow window accumulates a Welford variance estimate of the
unconstrained draws; at the window's end the diagonal inverse mass becomes
the regularized variance and dual averaging restarts around the current
step size. Doubling windows let early (badly-conditioned) estimates be
thrown away — this is what the naive two-phase scheme got wrong on stiff
targets (phase A barely moves, so its variance estimate is garbage).

The window structure is static Python; each window is one ``lax.scan``, so
the whole warmup still compiles into a single program per chain and vmaps
over chains.

Two tiers:

- :func:`run_warmup` — per-chain adaptation (each vmapped chain adapts its
  own step size / mass from its own history).
- :func:`run_warmup_pooled` — POOLED adaptation (SURVEY.md §2b item 5):
  one shared (eps, inv_mass) adapted from the accept statistics and draws
  of ALL chains, across shards via collectives. At 10^4 chains each
  dual-averaging update sees 10^4 accept probabilities instead of 1 and
  the Welford mass estimate converges ~10^4x faster per iteration.
  Cross-shard pooling follows the repo's fixed-reduction-order rule
  (parallel/distributed.py): per-shard partial sums are all_gathered in
  shard order and reduced identically on every shard, so the adapted
  (eps, inv_mass) are bitwise-identical for any dp size (asserted 1-vs-8
  devices in tests/test_pooled_adaptation.py).
"""

import math

import jax
import jax.numpy as jnp

from modppl_tpu.inference.hmc import da_init, da_update


def warmup_schedule(num_warmup, init_buffer=None, term_buffer=None,
                    base_window=25):
    """Return (fast1, [slow window sizes], fast2) summing to num_warmup."""
    if num_warmup < 20:
        return num_warmup, [], 0
    fast1 = init_buffer if init_buffer is not None else max(num_warmup * 15 // 100, 10)
    fast2 = term_buffer if term_buffer is not None else max(num_warmup * 10 // 100, 10)
    slow_total = num_warmup - fast1 - fast2
    if slow_total <= 0:
        return num_warmup, [], 0
    windows = []
    w = base_window
    remaining = slow_total
    while remaining > 0:
        if remaining < 2 * w or remaining < base_window:
            windows.append(remaining)
            remaining = 0
        else:
            windows.append(w)
            remaining -= w
            w *= 2
    return fast1, windows, fast2


def run_warmup(key, u0, transition, num_warmup, eps0, target_accept=0.8):
    """Adapt (step size, diagonal inverse mass) for `transition`.

    transition(key, u, eps, inv_mass) -> (u, accept_prob).
    Returns (u, eps, inv_mass).
    """
    fast1, slow, fast2 = warmup_schedule(num_warmup)
    zeros = jnp.zeros_like(u0)
    inv_mass = jnp.ones_like(u0)

    def make_body(inv_mass, adapt_mass):
        def body(carry, k):
            u, da, mean, m2, n = carry
            eps = jnp.exp(da["log_eps"])
            u, aprob = transition(k, u, eps, inv_mass)
            da = da_update(da, aprob, target=target_accept)
            if adapt_mass:
                n = n + 1.0
                delta = u - mean
                mean = mean + delta / n
                m2 = m2 + delta * (u - mean)
            return (u, da, mean, m2, n), aprob

        return body

    def run_phase(phase_key, u, da, inv_mass, length, adapt_mass):
        carry = (u, da, zeros, zeros, jnp.zeros(()))
        keys = jax.random.split(phase_key, max(length, 1))
        carry, _ = jax.lax.scan(make_body(inv_mass, adapt_mass), carry, keys)
        return carry

    phase = 0
    u, da = u0, da_init(eps0)
    if fast1 > 0:
        u, da, *_ = run_phase(jax.random.fold_in(key, phase), u, da,
                              inv_mass, fast1, False)
        phase += 1
    for w in slow:
        u, da, mean, m2, n = run_phase(jax.random.fold_in(key, phase), u, da,
                                       inv_mass, w, True)
        phase += 1
        var = m2 / jnp.maximum(n - 1.0, 1.0)
        # regularize toward unit scale as Stan does (n/(n+5) shrinkage)
        shrink = n / (n + 5.0)
        var = shrink * var + (1.0 - shrink) * 1e-3
        # ROUND-5 FIX: inv_mass is M^-1 in the transition (p ~ N(0, M) is
        # drawn as z/sqrt(inv_mass); u += eps*inv_mass*p), so optimal
        # preconditioning sets it to the VARIANCE estimate (Stan's
        # inv_metric = Sigma), NOT 1/var. The inverted form made the
        # leapfrog frequency eps*precision on stiff coordinates —
        # measured 400x-smaller adapted step sizes on the hierarchical
        # target (eps 0.0017 vs 0.7 at the same accept rate).
        inv_mass = jnp.clip(var, 1e-8, 1e8)
        # restart dual averaging around the current adapted step size
        da = da_init(jnp.exp(da["log_eps_bar"]))
    if fast2 > 0:
        u, da, *_ = run_phase(jax.random.fold_in(key, phase), u, da,
                              inv_mass, fast2, False)
    eps = jnp.exp(da["log_eps_bar"])
    return u, eps, inv_mass


# --------------------------------------------------------------------------
# Pooled (cross-chain / cross-shard) adaptation
# --------------------------------------------------------------------------

def _tree_sum(x):
    """Sum over the leading axis by an EXPLICIT adjacent-pairing add tree.

    ``jnp.sum``/reduce must not be used where bitwise layout invariance is
    required: XLA lowers a reduce to different accumulation orders
    depending on fusion context (measured on CPU: the same (8,) f64
    reduce produced 3 distinct 1-ulp results in different programs).
    Explicit adds fix the association in the HLO graph itself — XLA does
    not reassociate floating-point adds.

    Pairing is ADJACENT (x[0]+x[1], x[2]+x[3], ...) per level, so the
    global tree over n = s * l leaves (s, l powers of two) decomposes
    exactly into s disjoint l-leaf subtrees plus the s-partial upper tree
    — which is what makes the sharded path of :func:`_pooled_sum`
    bitwise-equal to the unsharded one. Odd extents are padded with zeros
    (exact: x + 0.0 == x for finite/inf x).
    """
    n = x.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = jnp.concatenate(
            [x, jnp.zeros((p - n,) + x.shape[1:], x.dtype)], axis=0)
    while p > 1:
        p //= 2
        x = x[0::2] + x[1::2]
    return x[0]


# the pooled sum cuts the C chains into gcd(C, _POOL_BLOCKS) equal blocks
# of consecutive chains: every power-of-two shard count up to this that
# divides C divides the block count, so each shard holds whole blocks
_POOL_BLOCKS = 64


def _pooled_sum(x, axis_name):
    """Sum ``x`` over its leading (chain) axis with a FIXED reduction order.

    The C chains (all shards together) are cut into
    ``gcd(C, _POOL_BLOCKS)`` equal blocks of consecutive chains — a
    function of C only. Each block is reduced by its own add tree, and the
    block totals by one more. Sharded (inside shard_map with
    ``axis_name``), each shard reduces its own blocks and the totals are
    all_gathered in shard order. For any power-of-two shard count up to
    ``_POOL_BLOCKS`` that divides C this is the SAME tree, so the pooled
    statistics (and therefore the adapted eps / inverse mass) are
    bitwise-identical across layouts (asserted 1-vs-8 devices in
    tests/test_pooled_adaptation.py, 1-vs-4 at 10 chains per shard in
    tests/test_chip_smoke.py).
    """
    # materialize the addends first: without the barrier the producer ops
    # fuse into the adds (FMA contraction / recomputation), and the fusion
    # differs between program contexts — measured 1-ulp drift on CPU
    x = jax.lax.optimization_barrier(x)
    c_local = x.shape[0]
    n_shards = 1 if axis_name is None else jax.lax.axis_size(axis_name)
    block = c_local * n_shards // math.gcd(c_local * n_shards, _POOL_BLOCKS)
    if c_local % block:
        # a shard count that does not divide the block count: one block
        # per shard (a valid sum, but no longer layout-invariant)
        block = c_local
    blocks = x.reshape((c_local // block, block) + x.shape[1:])
    totals = _tree_sum(jnp.swapaxes(blocks, 0, 1))
    if axis_name is not None:
        totals = jax.lax.all_gather(totals, axis_name, tiled=True)
    return _tree_sum(totals)


def run_warmup_pooled(key, u0s, transition, num_warmup, eps0,
                      target_accept=0.8, axis_name=None,
                      batched_transition=False):
    """Adapt ONE shared (step size, diagonal inverse mass) from all chains.

    Args:
      key: scalar PRNG key (identical on every shard when sharded).
      u0s: (C_local, dim) initial unconstrained positions (the local chain
        slice when running inside shard_map).
      transition: per-chain ``(key, u, eps, inv_mass) -> (u, accept_prob)``,
        or — with ``batched_transition=True`` — a whole-batch
        ``(key, us, eps, inv_mass) -> (us, accept_probs)`` (a transition
        that already works on the whole chain block and must not be
        vmapped).
      num_warmup: total warmup iterations (Stan windowing, as run_warmup).
      axis_name: mesh axis name when called inside shard_map; partial
        sums cross shards via all_gather in shard order.

    Per-chain PRNG streams are derived from GLOBAL chain indices
    (shard_index * C_local + local_index), so chain i sees the same keys
    under any sharding layout.

    Returns (us, eps, inv_mass): final positions (C_local, dim), shared
    scalar step size, shared (dim,) inverse mass.
    """
    fast1, slow, fast2 = warmup_schedule(num_warmup)
    c_local = u0s.shape[0]
    dim_shape = u0s.shape[1:]
    dt = u0s.dtype
    zeros = jnp.zeros(dim_shape, dt)
    inv_mass = jnp.ones(dim_shape, dt)
    if axis_name is None:
        c_total = jnp.asarray(float(c_local), dt)
        idx0 = 0
    else:
        c_total = jnp.asarray(float(c_local), dt) * jax.lax.psum(
            jnp.ones((), dt), axis_name)
        idx0 = jax.lax.axis_index(axis_name) * c_local
    gidx = idx0 + jnp.arange(c_local)

    def make_body(inv_mass, adapt_mass):
        def body(carry, k):
            # barriers bracket the per-chain transition so its subgraph is
            # insulated from surrounding-program fusion decisions: without
            # them, the same transition arithmetic compiles to 1-ulp-
            # different results in different callers (e.g. hmc() vs
            # shardmap_hmc()), breaking cross-layout bitwise equality
            us, da, mean, m2, n = jax.lax.optimization_barrier(carry)
            eps = jnp.exp(da["log_eps"])
            if batched_transition:
                us, aprobs = transition(k, us, eps, inv_mass)
            else:
                keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(gidx)
                us, aprobs = jax.vmap(
                    lambda kk, uu: transition(kk, uu, eps, inv_mass))(keys, us)
            us, aprobs = jax.lax.optimization_barrier((us, aprobs))
            a_mean = _pooled_sum(aprobs, axis_name) / c_total
            da = da_update(da, a_mean, target=target_accept)
            if adapt_mass:
                # batched (Chan) Welford update pooling the whole iteration's
                # C_total draws at once
                b_mean = _pooled_sum(us, axis_name) / c_total
                b_m2 = _pooled_sum((us - b_mean[None]) ** 2, axis_name)
                n_new = n + c_total
                delta = b_mean - mean
                mean = mean + delta * c_total / n_new
                m2 = m2 + b_m2 + delta * delta * n * c_total / n_new
                n = n_new
            return (us, da, mean, m2, n), a_mean

        return body

    def run_phase(phase_key, us, da, inv_mass, length, adapt_mass):
        carry = (us, da, zeros, zeros, jnp.zeros((), dt))
        keys = jax.random.split(phase_key, max(length, 1))
        carry, a_means = jax.lax.scan(make_body(inv_mass, adapt_mass),
                                      carry, keys)
        return carry, a_means

    phase = 0
    us, da = u0s, da_init(jnp.asarray(eps0, dt))
    if fast1 > 0:
        (us, da, *_), _ = run_phase(jax.random.fold_in(key, phase), us, da,
                                    inv_mass, fast1, False)
        phase += 1
    for w in slow:
        (us, da, mean, m2, n), _ = run_phase(
            jax.random.fold_in(key, phase), us, da, inv_mass, w, True)
        phase += 1
        var = m2 / jnp.maximum(n - 1.0, 1.0)
        shrink = n / (n + 5.0)
        var = shrink * var + (1.0 - shrink) * 1e-3
        # ROUND-5 FIX: inv_mass is M^-1 in the transition (p ~ N(0, M) is
        # drawn as z/sqrt(inv_mass); u += eps*inv_mass*p), so optimal
        # preconditioning sets it to the VARIANCE estimate (Stan's
        # inv_metric = Sigma), NOT 1/var. The inverted form made the
        # leapfrog frequency eps*precision on stiff coordinates —
        # measured 400x-smaller adapted step sizes on the hierarchical
        # target (eps 0.0017 vs 0.7 at the same accept rate).
        inv_mass = jnp.clip(var, 1e-8, 1e8)
        da = da_init(jnp.exp(da["log_eps_bar"]))
    if fast2 > 0:
        (us, da, *_), _ = run_phase(jax.random.fold_in(key, phase), us, da,
                                    inv_mass, fast2, False)
    eps = jnp.exp(da["log_eps_bar"])
    return us, eps, inv_mass
