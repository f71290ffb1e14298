"""Vectorized resampling kernels.

Replacement for the reference's scalar multinomial resampling loop
(modppl/src/inference/particle_filter.rs:37-41 driving the inverse-CDF scan
at categorical.rs:24-31): ancestor indices are computed with one
cumulative-sum + one scatter + one cumulative-sum — all O(N) data-parallel
ops — and the "clone the selected traces" loop (particle_filter.rs:109-114)
becomes a single index-gather over the batched trace pytree's leaves.

Why not searchsorted: binary search over N particles costs log2(N)
dependent random-access gather passes (~20 for 10^6 particles). For the
*uniform grid* of systematic positions the inverse map is closed-form:

    S_j   = ceil(N * cdf_j - u)        # first grid position index > cdf_j
    z[s]  = #{j : S_j == s}            # one scatter-add
    a[i]  = #{j : S_j <= i} = cumsum(z)[i]   # = parent of grid position i

The scatter-add is integer arithmetic, so its result does not depend on
the order in which a parallel backend applies the adds.

Systematic resampling (stratified, single-uniform) is the default for the
compiled tier: lower variance than multinomial and — because it consumes a
single uniform — the natural basis for bitwise-deterministic distributed
resampling (see parallel/distributed.py).
"""

import jax
import jax.numpy as jnp


def _normalized_cdf(log_normalized_weights):
    cdf = jnp.cumsum(jnp.exp(log_normalized_weights))
    return cdf / cdf[-1]


def _grid_parents(cdf, u, num):
    """Ancestors of the position grid (u + arange(num))/num via scatter+cumsum."""
    n_in = cdf.shape[0]
    s = jnp.ceil(cdf * num - u).astype(jnp.int32)
    s = jnp.clip(s, 0, num)
    # monotonicity repair: XLA's parallel-prefix f32 cumsum can locally
    # invert cdf; sorted S keeps the ancestors sorted (the sharded tier's
    # halo exchange relies on that), and the integer cummax is exact.
    s = jax.lax.cummax(s)
    z = jnp.zeros(num + 1, jnp.int32).at[s].add(1)
    parents = jnp.cumsum(z[:num])
    return jnp.clip(parents, 0, n_in - 1)


def systematic_parents(key, log_normalized_weights, num=None):
    """Systematic (stratified, single-uniform) ancestors.

    positions_i = (u + i)/num against the weight CDF; deterministic given
    (key, weights) and invariant to particle-axis sharding layout.
    """
    n_in = log_normalized_weights.shape[0]
    n = num if num is not None else n_in
    u = jax.random.uniform(key, (), log_normalized_weights.dtype)
    return _grid_parents(_normalized_cdf(log_normalized_weights), u, n)


def multinomial_parents(key, log_normalized_weights, num=None):
    """IID categorical ancestors (reference semantics, particle_filter.rs:37-41).

    Uses sorted-uniform inversion: iid uniforms are sorted in O(N log N) and
    inverted against the CDF with the same O(N) grid trick (the sorted
    sample of N uniforms is distributionally a jittered grid), avoiding both
    an N x N Gumbel matrix and per-draw binary searches. Ancestors come out
    sorted; exchangeability of the particle system makes that immaterial.
    """
    n_in = log_normalized_weights.shape[0]
    n = num if num is not None else n_in
    cdf = _normalized_cdf(log_normalized_weights)
    us = jnp.sort(jax.random.uniform(key, (n,), log_normalized_weights.dtype))
    # parent[i] = #{j : cdf_j < us_i}: scatter each cdf_j into the sorted-u
    # grid via searchsorted on the *uniforms* — both arrays sorted, so one
    # searchsorted of cdf (size N) into us (size n) suffices.
    s = jnp.searchsorted(us, cdf, side="left").astype(jnp.int32)
    z = jnp.zeros(n + 1, jnp.int32).at[jnp.clip(s, 0, n)].add(1)
    parents = jnp.cumsum(z[:n])
    return jnp.clip(parents, 0, n_in - 1)


def stratified_parents(key, log_normalized_weights, num=None):
    """Stratified ancestors: one independent uniform per output stratum.

    positions_i = (u_i + i)/num with iid u_i — lower variance than
    multinomial, slightly higher than systematic, but with N independent
    stratification variables (useful when the single systematic uniform's
    coupling is undesirable, e.g. for some particle-MCMC estimators).
    Same O(N) scatter+cumsum inverse as the systematic kernel.
    """
    n_in = log_normalized_weights.shape[0]
    n = num if num is not None else n_in
    cdf = _normalized_cdf(log_normalized_weights)
    us = jax.random.uniform(key, (n,), log_normalized_weights.dtype)
    # first stratum index whose position (i + u_i)/n exceeds cdf_j:
    # i >= n*cdf_j - u_i is stratum-dependent; invert by locating each cdf_j
    # against the per-stratum positions with a searchsorted on the sorted
    # positions (they are sorted by construction: (i + u_i) strictly
    # increasing since u_i in [0,1)).
    positions = (jnp.arange(n, dtype=cdf.dtype) + us) / n
    s = jnp.searchsorted(positions, cdf, side="left").astype(jnp.int32)
    z = jnp.zeros(n + 1, jnp.int32).at[jnp.clip(s, 0, n)].add(1)
    parents = jnp.cumsum(z[:n])
    return jnp.clip(parents, 0, n_in - 1)


def residual_parents(key, log_normalized_weights, num=None):
    """Residual-systematic resampling: deterministic floor(N w) copies plus a
    systematic sweep over the residual weights for the R = N - sum(floor)
    remaining slots.

    Fully vectorized with static shapes even though R is data-dependent:
    both blocks are grid-inverses (scatter + cumsum) — the deterministic
    block on cumsum(floor(N w)), the residual block on the R-point
    systematic grid ceil(R * resid_cdf - u) — and the blocks are stitched
    with a shifted gather.
    """
    n_in = log_normalized_weights.shape[0]
    n = num if num is not None else n_in
    w = jnp.exp(log_normalized_weights)
    w = w / jnp.sum(w)
    counts = jnp.floor(n * w).astype(jnp.int32)
    num_det = jnp.sum(counts)
    # deterministic block: parents of slots [0, num_det) = repeat by counts
    cum = jnp.cumsum(counts)  # S_j = first slot after particle j's copies
    z = jnp.zeros(n + 1, jnp.int32).at[jnp.clip(cum, 0, n)].add(1)
    det_parents = jnp.clip(jnp.cumsum(z[:n]), 0, n_in - 1)
    # residual block: systematic sweep of R slots over the residual mass
    resid = n * w - counts
    r_total = jnp.asarray(n, w.dtype) - num_det.astype(w.dtype)  # R as traced
    resid_cdf = jnp.cumsum(resid)
    resid_cdf = resid_cdf / resid_cdf[-1]
    u = jax.random.uniform(key, (), w.dtype)
    s_res = jnp.clip(jnp.ceil(resid_cdf * r_total - u), 0, n).astype(jnp.int32)
    z_res = jnp.zeros(n + 1, jnp.int32).at[s_res].add(1)
    res_rank = jnp.clip(jnp.cumsum(z_res[:n]), 0, n_in - 1)  # rank on R-grid
    # slots >= num_det take residual draw (k - num_det) on the R-grid
    idx = jnp.arange(n, dtype=jnp.int32)
    shifted = jnp.take(res_rank, jnp.clip(idx - num_det, 0, n - 1))
    return jnp.where(idx >= num_det, shifted, det_parents)


RESAMPLERS = {
    "multinomial": multinomial_parents,
    "systematic": systematic_parents,
    "stratified": stratified_parents,
    "residual": residual_parents,
}


def gather_particles(tree, parents):
    """traces[i] = traces[parents[i]] as one XLA gather over every leaf.

    Replaces the O(N*T) per-particle trace clone at particle_filter.rs:109-114.
    """
    return jax.tree_util.tree_map(lambda x: jnp.take(x, parents, axis=0), tree)
