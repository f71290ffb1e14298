"""Sharded batched-tier SMC: the fast single-chip filter over a device mesh.

VERDICT r3 #1 / SURVEY.md:120-123: the round-3 multi-chip path ran the slow
vmapped tier and `all_gather`ed the FULL particle state to every shard —
O(N·C) memory and bandwidth per shard per resample. This module shards the
fast batched tier (inference/vsmc.batched_particle_filter) itself, and its
resampling exchanges only what moves:

- **Extend** runs as the GLOBAL batched program (auto-batch plate streams,
  modeling/autobatch.py), partitioned over the mesh's ``dp`` axis by XLA via
  sharding constraints. ``jax_threefry_partitionable`` (JAX's default
  counter-based PRNG partitioning) makes every plate draw bitwise
  layout-invariant, so no per-shard RNG bookkeeping is needed.
- **Weight reductions** (normalization, ESS, log-ML) run inside a
  ``shard_map`` block with the repo's fixed-reduction-order discipline
  (adjacent-pairing add trees, inference/adaptation._pooled_sum): bitwise
  identical for any power-of-two layout.
- **The CDF** is a layout-invariant blocked cumulative sum: an explicit
  Hillis-Steele shift-add scan inside fixed-width blocks plus a replicated
  block-offset prefix — the same add tree regardless of sharding (XLA's own
  cumsum lowers to different reduction orders in different programs).
- **Ancestors**: the sorted slot-position vector S is ``all_gather``ed —
  O(N) *int32*, never the state — and parents come from the exact integer
  scatter+cumsum inverse (bit-identical to parallel/resample.py on the
  same S).
- **State exchange** moves only boundary segments: systematic ancestors are
  sorted, so shard k's parents form a contiguous source range around its own
  block. The fast path ``ppermute``s an H-row halo from each neighbour
  (O(H·C) bytes); when some shard's parent range escapes its halo window
  (degenerate weight concentration) a ring rotation fallback runs — O(L·C)
  peak memory, never materializing an (N, C) buffer on any shard.

Reference: modppl/src/inference/particle_filter.rs:103-116 (the sequential
clone loop all of this replaces).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from modppl_tpu.inference import vsmc
from modppl_tpu.parallel.mesh import constrain_particles

_B0 = 1024        # max CDF block width
_MIN_BLOCKS = 64  # min block count (=> layouts up to 64 shards share blocks)


def _doubling_cumsum(x):
    """Inclusive cumsum along the last axis with a FIXED shift-add structure
    (Hillis-Steele: log2(n) strided adds). XLA does not reassociate float
    adds, so the result is bitwise identical wherever the row content is —
    unlike ``jnp.cumsum``, whose reduce-window lowering picks different
    summation trees in different program contexts (the repo's documented
    non-monotone-cumsum pitfall)."""
    n = x.shape[-1]
    k = 1
    pad = [(0, 0)] * (x.ndim - 1)
    while k < n:
        x = x + jnp.pad(x, pad + [(k, 0)])[..., :n]
        k *= 2
    return x


def _cdf_block(num_particles):
    """Block width for the layout-invariant CDF — a function of N ONLY, so
    every layout of the same problem uses the same blocks."""
    n_blocks = max(num_particles // _B0, _MIN_BLOCKS)
    if num_particles % n_blocks:
        raise ValueError(
            f"sharded filter: num_particles {num_particles} must be a "
            f"multiple of {n_blocks} (power-of-two sizes)")
    return num_particles // n_blocks


def _det_sum(x_local, axis_name, num_total):
    """Fixed-order sum over the (possibly sharded) particle axis.

    Blocked: per-block totals come from the Hillis-Steele scan's last
    column (the same fixed add structure as the CDF), then the ≤ N/block
    totals are all_gathered in shard order and reduced by the explicit
    adjacent-pairing tree. Bitwise layout-invariant, and far fewer strided
    slices than a full-length element tree (_tree_sum) at N = 2^20."""
    from modppl_tpu.inference.adaptation import _tree_sum

    block = _cdf_block(num_total)
    rows = jax.lax.optimization_barrier(x_local.reshape(-1, block))
    totals = _doubling_cumsum(rows)[:, -1]
    if axis_name is not None:
        totals = jax.lax.all_gather(totals, axis_name, tiled=True)
    return _tree_sum(totals)


def det_logsumexp(lw_local, axis_name, num_total):
    """logsumexp over the (possibly sharded) particle axis with exact max
    (pmax) and fixed-order blocked summation — bitwise layout-invariant."""
    m = jnp.max(lw_local)
    if axis_name is not None:
        m = jax.lax.pmax(m, axis_name)
    s = _det_sum(jnp.exp(lw_local - m), axis_name, num_total)
    return m + jnp.log(s)


def _det_grid_positions(key, lw_local, axis_name, num_particles):
    """Sorted systematic slot positions S (parallel/resample.py:34-46
    semantics) for the sharded layout: S_j = cummax(ceil(N * cdf_j - u)),
    computed with the layout-invariant CDF. Integer cummax crosses shards by
    exact running maxima. Returns (s_local, log_total, ess)."""
    n = num_particles
    n_local = lw_local.shape[0]
    block = _cdf_block(n)
    m = jnp.max(lw_local)
    if axis_name is not None:
        m = jax.lax.pmax(m, axis_name)
    e = jnp.exp(lw_local - m)
    # ONE blocked scan pass for both Σe (CDF + normalizer) and Σe² (ESS):
    # the e and e² rows are stacked so the Hillis-Steele shifts touch the
    # data once. ESS = (Σe)²/Σe² (scale-invariant).
    stacked = jnp.stack([e.reshape(-1, block), (e * e).reshape(-1, block)])
    stacked = jax.lax.optimization_barrier(stacked)
    c2 = _doubling_cumsum(stacked)
    cum = c2[0]
    totals = c2[0, :, -1]
    sq_totals = c2[1, :, -1]
    if axis_name is not None:
        totals = jax.lax.all_gather(totals, axis_name, tiled=True)
        sq_totals = jax.lax.all_gather(sq_totals, axis_name, tiled=True)
    from modppl_tpu.inference.adaptation import _tree_sum

    offs_incl = _doubling_cumsum(totals[None, :])[0]
    offs_excl = jnp.concatenate(
        [jnp.zeros((1,), totals.dtype), offs_incl[:-1]])
    if axis_name is not None:
        idx0 = jax.lax.axis_index(axis_name) * (n_local // block)
        my_offs = jax.lax.dynamic_slice_in_dim(
            offs_excl, idx0, n_local // block)
    else:
        my_offs = offs_excl
    total = offs_incl[-1]
    log_total = m + jnp.log(total)
    ess = (total * total) / _tree_sum(sq_totals)
    u = jax.random.uniform(key, (), lw_local.dtype)
    cdf = (cum + my_offs[:, None]).reshape(n_local)
    s = jnp.clip(jnp.ceil((cdf / total) * n - u), 0, n).astype(jnp.int32)
    s = jax.lax.cummax(s)  # local repair (exact integer max)
    if axis_name is not None:
        last = s[-1]
        lasts = jax.lax.all_gather(last, axis_name, tiled=False)
        # exclusive running max of shard maxima (replicated, exact)
        prev = jax.lax.associative_scan(jnp.maximum, lasts)
        prev = jnp.concatenate(
            [jnp.full((1,), jnp.iinfo(jnp.int32).min, jnp.int32), prev[:-1]])
        me = jax.lax.axis_index(axis_name)
        s = jnp.maximum(s, prev[me])
    return s, log_total, ess


def _halo_gather(state_local, parents_local, axis_name, n_shards, halo):
    """Fast-path exchange: window = [left halo | own block | right halo]
    via two neighbour ppermutes, then a local row gather. Caller guarantees
    every parent falls inside the window."""
    me = jax.lax.axis_index(axis_name)
    n_local = parents_local.shape[0]
    base = me * n_local - halo
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [((i + 1) % n_shards, i) for i in range(n_shards)]

    def one(leaf):
        left = jax.lax.ppermute(leaf[-halo:], axis_name, fwd)
        right = jax.lax.ppermute(leaf[:halo], axis_name, bwd)
        window = jnp.concatenate([left, leaf, right], axis=0)
        idx = jnp.clip(parents_local - base, 0, n_local + 2 * halo - 1)
        return jnp.take(window, idx, axis=0)

    return jax.tree_util.tree_map(one, state_local)


def _ring_gather(state_local, parents_local, axis_name, n_shards):
    """Fallback exchange: rotate the local block around the ring; each
    round, rows whose parent lives in the resident block are selected.
    O(L·C) peak memory — an (N, C) buffer never exists on any shard."""
    me = jax.lax.axis_index(axis_name)
    n_local = parents_local.shape[0]
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    src_shard = parents_local // n_local

    buf = state_local
    out = jax.tree_util.tree_map(jnp.zeros_like, state_local)
    for r in range(n_shards):
        src = (me - r) % n_shards
        sel = src_shard == src
        idx = jnp.clip(parents_local - src * n_local, 0, n_local - 1)
        out = jax.tree_util.tree_map(
            lambda o, b: jnp.where(
                sel.reshape((-1,) + (1,) * (o.ndim - 1)),
                jnp.take(b, idx, axis=0), o),
            out, buf)
        if r < n_shards - 1:
            buf = jax.tree_util.tree_map(
                lambda b: jax.lax.ppermute(b, axis_name, fwd), buf)
    return out


def _parents_from_s(s, num_particles):
    """Ancestors from the sorted slot-position vector S by the exact
    integer scatter+cumsum inverse (parallel/resample._grid_parents
    semantics): parents[i] = #{j : S_j <= i}. All-integer, so the result is
    identical under any summation order / layout — and one pass where the
    searchsorted form needs log2(N) dependent gather passes."""
    n = num_particles
    z = jnp.zeros(n + 1, jnp.int32).at[s].add(1)
    return jnp.clip(jnp.cumsum(z[:n]), 0, n - 1)


def make_resample_step(mesh, num_particles, ess_threshold, axis="dp",
                       halo=None):
    """Build the per-step (maybe-)resample block.

    Returns ``fn(key, lw_local_or_global, state) -> (state, lw, d_log_ml,
    parents, ess, resampled)``; under a multi-device mesh the function is a
    ``shard_map`` over the ``dp`` axis, under a 1-device mesh (or
    ``mesh=None``) it is the identical math with every collective elided —
    the two are bitwise-equal (asserted in tests/test_sharded_batched.py).
    """
    n_shards = 1 if mesh is None else int(mesh.shape[axis])
    n_local = num_particles // n_shards
    if halo is None:
        halo = max(min(n_local // 4, num_particles // (2 * n_shards)), 1)
    halo = int(min(halo, n_local))
    axis_name = axis if n_shards > 1 else None

    def local_fn(key, lw_local, state_local):
        lw_local, state_local = jax.lax.optimization_barrier(
            (lw_local, state_local))
        k_pos = jax.random.fold_in(key, 0)
        s, log_total, ess = _det_grid_positions(
            k_pos, lw_local, axis_name, num_particles)
        do = ess < ess_threshold * num_particles
        me = 0 if axis_name is None else jax.lax.axis_index(axis_name)
        slots = me * n_local + jnp.arange(n_local, dtype=jnp.int32)

        def resample_branch(args):
            s, state_local = args
            if axis_name is None:
                parents = _parents_from_s(s, num_particles)
                new_state = jax.tree_util.tree_map(
                    lambda x: jnp.take(x, parents, axis=0), state_local)
                return new_state, parents
            s_all = jax.lax.all_gather(s, axis_name, tiled=True)  # int32 O(N)
            parents_all = _parents_from_s(s_all, num_particles)
            parents = jax.lax.dynamic_slice_in_dim(
                parents_all, me * n_local, n_local)
            # replicated per-shard parent ranges decide halo sufficiency
            firsts = jnp.arange(n_shards, dtype=jnp.int32) * n_local
            lasts = firsts + (n_local - 1)
            lo_k = parents_all[firsts]
            hi_k = parents_all[lasts]
            fits = jnp.all((lo_k >= firsts - halo)
                           & (hi_k <= lasts + halo))
            new_state = jax.lax.cond(
                fits,
                lambda st: _halo_gather(st, parents, axis_name, n_shards,
                                        halo),
                lambda st: _ring_gather(st, parents, axis_name, n_shards),
                state_local)
            return new_state, parents

        def keep_branch(args):
            _, state_local = args
            return state_local, slots

        if ess_threshold >= 1.0:
            # threshold 1.0 = resample every step (vsmc.py convention; the
            # sole skip case, bitwise-uniform weights, makes the resample
            # an exact identity) — specialize away the lax.cond, which
            # would otherwise wrap the whole gather inside the scan
            new_state, parents = resample_branch((s, state_local))
            do = jnp.asarray(True)
            lw_out = jnp.zeros_like(lw_local)
            d_log_ml = log_total - jnp.log(float(num_particles))
        else:
            new_state, parents = jax.lax.cond(
                do, resample_branch, keep_branch, (s, state_local))
            lw_out = jnp.where(do, jnp.zeros_like(lw_local), lw_local)
            d_log_ml = jnp.where(
                do, log_total - jnp.log(float(num_particles)), 0.0)
        return (jax.lax.optimization_barrier(new_state), lw_out, d_log_ml,
                parents, ess, do)

    if axis_name is None:
        return local_fn
    return shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(), P(axis), P(), P()),
        check_vma=False)


@partial(jax.jit, static_argnames=(
    "mesh", "kernel", "num_particles", "ess_threshold", "auto_batch",
    "halo", "store_ancestry", "proposal", "rejuvenation"))
def sharded_batched_particle_filter(mesh, key, kernel, state0,
                                    init_constraints, step_constraints,
                                    num_particles, ess_threshold=1.0,
                                    auto_batch=False, halo=None,
                                    store_ancestry=True, proposal=None,
                                    proposal_params=None,
                                    rejuvenation=None):
    """The fast batched-tier filter sharded over ``mesh``'s ``dp`` axis.

    Bitwise-deterministic across layouts: a dp=1 and a dp=8 run produce
    identical states, ancestors and log-ML (power-of-two sizes). Resampling
    is systematic (the collective scheme relies on sorted ancestors).

    Compared to round 3's `sharded_particle_filter` (vmapped tier + full
    state all_gather): per-particle extend cost drops to the batched tier's
    (one plate stream per address), and per-resample communication drops
    from O(N·C) to O(N) int32 (ancestors) + O(halo·C) state rows on the
    fast path.

    One compiled XLA program per (mesh, kernel, N, threshold) — repeated
    calls hit the jit cache (``mesh`` and the module-level kernel are
    hashable static arguments).
    """
    body, lse, kernel = _filter_parts(
        mesh, kernel, num_particles, ess_threshold, auto_batch, halo,
        store_ancestry, proposal, proposal_params, rejuvenation)

    s, _ = vsmc.batched_smc_init(key, kernel, state0, init_constraints,
                                 num_particles)
    s = vsmc.SMCState(s.key, constrain_particles(s.state, mesh),
                      constrain_particles(s.log_weights, mesh),
                      s.log_ml, s.t)

    s, (parents, ess, resampled) = jax.lax.scan(body, s, step_constraints)
    log_ml = s.log_ml + lse(s.log_weights) - jnp.log(float(num_particles))
    return {"state": s.state, "log_weights": s.log_weights,
            "log_ml": log_ml, "ancestors": parents, "ess": ess,
            "resampled": resampled}


def _filter_parts(mesh, kernel, num_particles, ess_threshold, auto_batch,
                  halo, store_ancestry, proposal, proposal_params,
                  rejuvenation):
    """Shared construction for the one-shot and checkpointed sharded
    filters (VERDICT r4 #3): auto-batch wrapping, the (shard_map'd)
    resample step, the deterministic logsumexp, and the per-step scan
    body. Returns (body, lse, wrapped_kernel); ``body`` has the exact
    per-step semantics of sharded_batched_particle_filter — chunking the
    scan over it on the host (inference/checkpointed.py) replays the
    identical per-step program, so a resumed run is bitwise-equal to an
    uninterrupted equally-chunked one at any dp."""
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
            "sharded filter: proposal/rejuvenation require auto_batch=True")
    n_shards = 1 if mesh is None else int(mesh.shape["dp"])
    if num_particles % max(n_shards, 1):
        raise ValueError("num_particles must divide over the dp axis")

    resample_step = make_resample_step(mesh, num_particles, ess_threshold,
                                       halo=halo)
    if mesh is not None and n_shards > 1:
        lse = shard_map(
            partial(det_logsumexp, axis_name="dp",
                    num_total=num_particles), mesh=mesh,
            in_specs=(P("dp"),), out_specs=P(), check_vma=False)
    else:
        lse = partial(det_logsumexp, axis_name=None,
                      num_total=num_particles)

    def body(carry, cons_t):
        key, k_res, k_gen, k_rej = jax.random.split(carry.key, 4)
        state, lw, d_log_ml, parents, ess, resampled = resample_step(
            k_res, carry.log_weights, carry.state)
        state = constrain_particles(state, mesh)
        lw = constrain_particles(lw, mesh)
        if proposal is None:
            trace, w = kernel.step.generate(k_gen, (carry.t, state),
                                            cons_t)
        else:
            # guided step (inference/vsmc.batched_smc_step semantics):
            # broadcast obs + merge per-particle proposed choices; every
            # op is elementwise over particles, so XLA partitions it with
            # no extra collectives and partitionable threefry keeps the
            # proposal draws layout-invariant
            k_prop, k_mod = jax.random.split(k_gen)
            pargs = ((carry.t, state, cons_t) if proposal_params is None
                     else (carry.t, state, cons_t, proposal_params))
            pchoices, plogjp = proposal.propose(k_prop, pargs,
                                                num_particles)
            cons = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(
                    x, (num_particles,) + jnp.shape(x)), cons_t)
            cons.merge(pchoices)
            trace, mw = kernel.step.generate_constrained_batched(
                k_mod, (carry.t, state), cons)
            w = mw - plogjp
        if rejuvenation is not None:
            selection, num_moves = rejuvenation
            trace = vsmc._rejuvenate(
                k_rej, trace, vsmc.ScanKernel(None, rejuvenation_kernel),
                selection, num_moves)
        new = vsmc.SMCState(
            key, constrain_particles(trace.retv, mesh),
            constrain_particles(lw + w, mesh),
            carry.log_ml + d_log_ml, carry.t + 1)
        # store_ancestry=False drops the (T, N) int32 ancestry stack from
        # the outputs (long filters / throughput runs where only states,
        # weights and log-ML are needed — the vsmc store_traces analog)
        return new, ((parents if store_ancestry else None), ess, resampled)

    return body, lse, kernel
