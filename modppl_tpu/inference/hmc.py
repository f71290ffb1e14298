"""Hamiltonian Monte Carlo with dual-averaging step-size and diagonal mass
adaptation.

Extension target beyond the reference (BASELINE.json north star; the
reference implements no gradient inference). ``logjp`` of any
static-structure model is differentiable by construction — the model's
fully-constrained ``assess`` weight *is* the log-joint — so HMC needs no
per-model code:

- The latent log-density over unconstrained space comes from
  :func:`make_unconstrained_logprob` (bijectors per address from the trie's
  recorded distributions).
- The transition, warmup (Nesterov dual averaging toward a target accept
  rate + Welford diagonal mass estimation), and sampling loops are all
  ``lax.scan``; chains are ``vmap``'d — the 10^4-chain workload is one XLA
  program whose chain axis shards over the device mesh.
"""

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from modppl_tpu.inference.transforms import transform_for


# --------------------------------------------------------------------------
# Unconstrained log-joint construction
# --------------------------------------------------------------------------

def latent_bijectors(trace, observed, selection=None):
    """Map each non-observed continuous address to its bijector.

    Discrete non-observed addresses raise (condition or marginalize them
    first) — gradients cannot flow through discrete choices.
    """
    out = {}
    discrete = []
    for addr in trace.data.addresses():
        if observed.search(addr) is not None:
            continue
        if selection is not None and selection.search(addr) is None:
            continue
        node = trace.data.search(addr)
        if node.dist is None:
            continue  # sub-genfn inner retv, not a random choice
        bij = transform_for(node.dist)
        if node.dist.is_discrete:
            discrete.append(addr)
            continue
        if bij is None:
            raise ValueError(
                f'hmc: no default unconstraining bijector for address "{addr}" '
                f"(dist {node.dist!r}, support {node.dist.support!r}); "
                "condition it or pass an explicit transform")
        out[addr] = bij
    if discrete:
        raise ValueError(
            f"hmc: discrete latent addresses {discrete} — observe them, "
            "marginalize them, or use MH/SMC for those choices")
    return out


def make_unconstrained_logprob(model, args, trace, observed, selection=None,
                               include_jacobian=True):
    """Build ``logprob(u) -> float`` over unconstrained latents.

    Returns (logprob, u0, bijectors, constrain) where u0 is the
    unconstrained image of the trace's current latent values and
    ``constrain(u)`` maps back to a {addr: value} dict.

    ``include_jacobian=False`` drops the log-det-Jacobian term: the
    result is the joint density in CONSTRAINED space evaluated through
    the change of variables — what constrained-space MAP optimization
    maximizes (inference/map_laplace.py) — rather than the density of the
    pushed-forward measure that HMC/NUTS/VI target.
    """
    bijectors = latent_bijectors(trace, observed, selection)

    def constrain(u):
        return {addr: bijectors[addr].forward(u[addr]) for addr in bijectors}

    def logprob(u):
        constraints = observed.copy()
        ldj = 0.0
        for addr, bij in bijectors.items():
            constraints.observe(addr, bij.forward(u[addr]))
            if include_jacobian:
                ldj = ldj + bij.log_det_jacobian(u[addr])
        # fully-constrained generate: weight == logjp (gfi.rs:87-90)
        w = model.assess(jax.random.PRNGKey(0), args, constraints)
        return w + ldj

    u0 = {addr: bijectors[addr].inverse(trace.data.read(addr))
          for addr in bijectors}
    return logprob, u0, bijectors, constrain


# --------------------------------------------------------------------------
# Leapfrog + transition
# --------------------------------------------------------------------------

def _leapfrog(grad_fn, u, p, eps, num_steps, inv_mass):
    """Standard leapfrog in flat coordinates; one fused scan."""

    def body(carry, _):
        u, p, g = carry
        p = p + 0.5 * eps * g
        u = u + eps * inv_mass * p
        g = grad_fn(u)
        p = p + 0.5 * eps * g
        return (u, p, g), None

    g = grad_fn(u)
    (u, p, g), _ = jax.lax.scan(body, (u, p, g), None, length=num_steps)
    return u, p


def hmc_transition(key, u_flat, logp_flat, grad_flat, eps, num_leapfrog,
                   inv_mass):
    """One HMC transition on flat unconstrained coordinates.

    Returns (u', logp(u'), accept_prob, divergent).
    """
    k_mom, k_acc, k_jit = jax.random.split(key, 3)
    # jitter the step size ±50% per transition: breaks the periodic-orbit
    # resonance of fixed-length trajectories on near-Gaussian targets
    eps = eps * jax.random.uniform(k_jit, (), minval=0.5, maxval=1.5)
    p0 = jax.random.normal(k_mom, u_flat.shape, u_flat.dtype) / jnp.sqrt(inv_mass)
    logp0 = logp_flat(u_flat)
    u_new, p_new = _leapfrog(grad_flat, u_flat, p0, eps, num_leapfrog, inv_mass)
    logp_new = logp_flat(u_new)
    h0 = -logp0 + 0.5 * jnp.sum(inv_mass * p0 * p0)
    h_new = -logp_new + 0.5 * jnp.sum(inv_mass * p_new * p_new)
    delta_h = h0 - h_new
    divergent = ~jnp.isfinite(delta_h) | (delta_h < -1000.0)
    accept_prob = jnp.where(divergent, 0.0, jnp.minimum(1.0, jnp.exp(delta_h)))
    accept = jax.random.uniform(k_acc, ()) < accept_prob
    u_out = jnp.where(accept, u_new, u_flat)
    logp_out = jnp.where(accept, logp_new, logp0)
    return u_out, logp_out, accept_prob, divergent


# --------------------------------------------------------------------------
# Dual averaging (Hoffman & Gelman 2014, Algorithm 5 constants)
# --------------------------------------------------------------------------

def da_init(eps0):
    log_eps = jnp.log(eps0)
    # scalars follow eps0's dtype: default-dtype zeros would promote the
    # whole carry to f64 under x64 even for an f32 chain state
    zero = jnp.zeros((), log_eps.dtype)
    return {
        "log_eps": log_eps,
        "log_eps_bar": log_eps,
        "h_bar": zero,
        "mu": jnp.log(10.0 * jnp.asarray(eps0, log_eps.dtype)),
        "t": zero,
    }


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state["t"] + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state["h_bar"] + eta_h * (target - accept_prob)
    log_eps = state["mu"] - jnp.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state["log_eps_bar"]
    return {"log_eps": log_eps, "log_eps_bar": log_eps_bar, "h_bar": h_bar,
            "mu": state["mu"], "t": t}


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def _single_chain(key, logprob, u0_flat, num_warmup, num_samples, eps0,
                  num_leapfrog, target_accept):
    from modppl_tpu.inference.adaptation import run_warmup

    grad = jax.grad(logprob)

    def warm_transition(k, u, eps, inv_mass):
        u, _, aprob, _ = hmc_transition(k, u, logprob, grad, eps,
                                        num_leapfrog, inv_mass)
        return u, aprob

    u, eps, inv_mass = run_warmup(
        jax.random.fold_in(key, 0), u0_flat, warm_transition, num_warmup,
        eps0, target_accept)

    def sample_body(u, k):
        u, logp, aprob, div = hmc_transition(k, u, logprob, grad, eps,
                                             num_leapfrog, inv_mass)
        return u, (u, logp, aprob, div)

    keys_s = jax.random.split(jax.random.fold_in(key, 2), num_samples)
    _, (us, logps, aprobs, divs) = jax.lax.scan(sample_body, u, keys_s)
    return us, logps, aprobs, divs, eps, inv_mass


# iterations per pre-draw segment of the fast pooled path. FIXED (layout-
# independent): the RNG stream is keyed by (phase, segment, global chain
# index), so any dp layout of the same problem replays identical
# per-chain randoms. 64 iterations bounds the resident pre-draw arrays to
# 64·C·(d+2) floats per segment.
_PREDRAW_SEG = 64

# outer-scan unroll of the single-shard fast pooled path: consecutive
# transitions are elementwise chains (accept-select feeds the next
# momentum scale and leapfrog), so unrolling lets XLA fuse across
# iterations and amortize per-iteration launch overhead. Sharded runs
# keep unroll=1 — their barriers block cross-iteration fusion anyway.
_OUTER_UNROLL = 4


def _phase_randoms(phase_key, gidx, length, dim, dtype):
    """Pre-draw one segment's per-transition randoms OUTSIDE the scan.

    Drawing inside the scan puts per-chain key folds, splits and draws in
    every iteration's body. Drawing a whole segment per chain up front
    turns that into three large fused RNG kernels. Streams are keyed by
    GLOBAL chain index (fold_in), so chain i sees the same randoms under
    any sharding.

    Returns (momenta_std (W, C, d), eps_jitter (W, C), accept_u (W, C)).
    """

    def per_chain(i):
        k = jax.random.fold_in(phase_key, i)
        mom = jax.random.normal(jax.random.fold_in(k, 0), (length, dim),
                                dtype)
        jit = jax.random.uniform(jax.random.fold_in(k, 1), (length,),
                                 dtype, minval=0.5, maxval=1.5)
        acc = jax.random.uniform(jax.random.fold_in(k, 2), (length,), dtype)
        return mom, jit, acc

    mom, jit, acc = jax.vmap(per_chain)(gidx)
    return (jnp.swapaxes(mom, 0, 1), jnp.swapaxes(jit, 0, 1),
            jnp.swapaxes(acc, 0, 1))


def _transition_batch(vag, U, LP, G, eps_shared, inv_mass, mom_t, jit_t,
                      acc_t, num_leapfrog):
    """One whole-batch HMC transition with pre-drawn randoms.

    The generic pooled path: (1) the carry holds (positions, logp,
    grad) so neither the start log-density nor the start gradient is ever
    recomputed (the scanned path paid one full logp + one grad per
    transition for values it already had); (2) each leapfrog step uses ONE
    vmapped value_and_grad, so the final logp is free; (3) the leapfrog
    loop is fully unrolled — for elementwise targets XLA fuses the whole
    trajectory into a handful of kernels instead of ~L launches.

    Per-chain arithmetic is identical to :func:`hmc_transition` (same
    divergence guard, same accept rule); the RNG stream is the pre-drawn
    one, not hmc_transition's fold_in/split stream.
    """
    eps = (eps_shared * jit_t)[:, None]               # (C, 1)
    p0 = mom_t / jnp.sqrt(inv_mass)[None, :]
    h0 = -LP + 0.5 * jnp.sum(inv_mass[None, :] * p0 * p0, -1)

    def lf(carry, _):
        u, p, lp, g = carry
        p = p + 0.5 * eps * g
        u = u + eps * inv_mass[None, :] * p
        lp, g = vag(u)
        p = p + 0.5 * eps * g
        return (u, p, lp, g), None

    # full unroll lets XLA fuse across leapfrog steps (elementwise
    # targets collapse to a handful of kernels); above dim 16 keep the
    # loop rolled — large log-density bodies (e.g. mvnormal's unrolled
    # Cholesky) make the unrolled HLO pathologically slow to compile
    (u, p, lp, g), _ = jax.lax.scan(lf, (U, p0, LP, G), None,
                                    length=num_leapfrog,
                                    unroll=U.shape[1] <= 16)
    h1 = -lp + 0.5 * jnp.sum(inv_mass[None, :] * p * p, -1)
    delta_h = h0 - h1
    divergent = ~jnp.isfinite(delta_h) | (delta_h < -1000.0)
    aprob = jnp.where(divergent, 0.0, jnp.minimum(1.0, jnp.exp(delta_h)))
    acc = acc_t < aprob
    U = jnp.where(acc[:, None], u, U)
    LP = jnp.where(acc, lp, LP)
    G = jnp.where(acc[:, None], g, G)
    return U, LP, G, aprob, divergent


def _pooled_chains(key, logprob, u0s, num_warmup, num_samples, eps0,
                   num_leapfrog, target_accept, axis_name=None):
    """All chains share ONE adapted (eps, inv_mass), pooled across chains
    (and shards, inside shard_map) — SURVEY.md §2b item 5.

    Batched transitions with pre-drawn per-segment randoms
    (:func:`_phase_randoms`), a (u, logp, grad) carry, and an unrolled
    value_and_grad leapfrog. This is the path every target runs. The RNG
    stream differs from the per-chain scanned stream of
    :func:`_single_chain`; bitwise layout invariance is preserved by
    construction — per-chain streams keyed by
    global chain index, pooled statistics via adaptation._pooled_sum's
    fixed add trees, barriers bracketing each transition (asserted dp1 vs
    dp8 and 1-process vs 2-process in tests/test_pooled_adaptation.py and
    tests/test_multiprocess.py).

    ``u0s``: (C_local, dim). Returns the same per-chain stacks as vmapping
    :func:`_single_chain`, plus the shared scalar eps.
    """
    from modppl_tpu.inference.adaptation import (
        _pooled_sum,
        warmup_schedule,
    )

    c_local, dim = u0s.shape
    dt = u0s.dtype
    vag_raw = jax.vmap(jax.value_and_grad(logprob))

    def vag(u):
        # the chain state's dtype rules: a model may accumulate its
        # log-density wider (e.g. float64 under x64 for float32 latents)
        lp, g = vag_raw(u)
        return lp.astype(dt), g.astype(dt)

    if axis_name is None:
        c_total = jnp.asarray(float(c_local), dt)
        gidx = jnp.arange(c_local)
        # single-shard: no cross-layout bitwise contract to honor, so
        # skip the fusion barriers and use XLA's own (single-kernel)
        # reductions — the barriers + explicit add trees exist to make
        # DIFFERENT shardings agree, which is moot at one shard, and they
        # block the cross-iteration fusion the unrolled scan relies on
        barrier = lambda x: x
        psum0 = lambda x: jnp.sum(x, axis=0)
        # unrolling quadruples trace/compile time; only worth it for
        # production-scale runs (the launch overhead it amortizes is
        # small on a short run and below ~512 chains). Above dim 16 back
        # off entirely: the unrolled-leapfrog x outer-unroll product
        # multiplies the log-density body ~32x, and a d=32 mvnormal
        # (O(d^3) unrolled small-dim Cholesky) makes that HLO very slow
        # to compile. The thresholds are not yet measured on a GPU.
        unroll = (_OUTER_UNROLL
                  if (num_warmup + num_samples) >= 256
                  and u0s.shape[0] >= 512 and dim <= 16 else 1)
    else:
        c_total = jnp.asarray(float(c_local), dt) * jax.lax.psum(
            jnp.ones((), dt), axis_name)
        gidx = jax.lax.axis_index(axis_name) * c_local + jnp.arange(c_local)
        barrier = jax.lax.optimization_barrier
        psum0 = lambda x: _pooled_sum(x, axis_name)
        unroll = 1

    zeros = jnp.zeros((dim,), dt)

    def make_body(inv_mass, adapt_mass, collect, adapt_da=True, ref=None):
        def body(carry, xs):
            # sharded path: barriers bracket the transition so its
            # subgraph is insulated from surrounding-program fusion (the
            # 1-ulp cross-caller drift documented in
            # adaptation.run_warmup_pooled)
            U, LP, G, da, s1, s2, n = barrier(carry)
            mom_t, jit_t, acc_t = xs
            eps = jnp.exp(da["log_eps"])
            U, LP, G, aprob, div = _transition_batch(
                vag, U, LP, G, eps, inv_mass, mom_t, jit_t, acc_t,
                num_leapfrog)
            U, LP, G, aprob = barrier((U, LP, G, aprob))
            if adapt_mass:
                # ONE fused reduction for all pooled statistics per
                # iteration (accept mean + first/second moments for the
                # windowed mass estimate) instead of three — at one
                # shard a single reduce kernel, sharded a single
                # all_gather of (2d+2,) partials. Moments accumulate
                # CENTERED at the window-start pooled mean `ref`: the raw
                # (uncentered) form cancels catastrophically in f32 when
                # a posterior sits far from the origin (|mean| >> sd —
                # e.g. mean 1e4, sd 0.1 loses ALL variance digits).
                # Chains sitting where the log-density is not finite are
                # not draws of the target: they count in the accept mean
                # (as rejections) but not in the moments.
                ok = jnp.isfinite(LP)[:, None]
                Uc = jnp.where(ok, U - ref[None, :], 0.0)
                stat = psum0(jnp.concatenate(
                    [aprob[:, None], ok.astype(dt), Uc, Uc * Uc], axis=1))
                a_mean = stat[0] / c_total
                s1 = s1 + stat[2: 2 + dim]
                s2 = s2 + stat[2 + dim:]
                n = n + stat[1]
            elif adapt_da:
                a_mean = psum0(aprob) / c_total
            if adapt_da:
                da = da_update(da, a_mean, target=target_accept)
            ys = (U, LP, aprob, div) if collect else None
            return (U, LP, G, da, s1, s2, n), ys

        return body

    def run_phase(phase_key, carry, inv_mass, length, adapt_mass,
                  collect=False, adapt_da=True, ref=None):
        body = make_body(inv_mass, adapt_mass, collect, adapt_da, ref)
        outs = []
        done, seg = 0, 0
        while done < length:
            k = min(_PREDRAW_SEG, length - done)
            xs = _phase_randoms(jax.random.fold_in(phase_key, seg), gidx,
                                k, dim, dt)
            carry, ys = jax.lax.scan(body, carry, xs, unroll=min(unroll, k))
            if collect:
                outs.append(ys)
            done += k
            seg += 1
        if collect:
            ys = jax.tree_util.tree_map(
                lambda *a: jnp.concatenate(a, axis=0), *outs) \
                if len(outs) > 1 else outs[0]
            return carry, ys
        return carry, None

    # ---- warmup: Stan windowed schedule (adaptation.warmup_schedule) ----
    fast1, slow, fast2 = warmup_schedule(num_warmup)
    inv_mass = jnp.ones((dim,), dt)
    LP0, G0 = vag(u0s)
    carry = (u0s, LP0, G0, da_init(jnp.asarray(eps0, dt)), zeros, zeros,
             jnp.zeros((), dt))
    phase = 0
    k_warm = jax.random.fold_in(key, 0)
    if fast1 > 0:
        carry, _ = run_phase(jax.random.fold_in(k_warm, phase), carry,
                             inv_mass, fast1, False)
        phase += 1
    for w in slow:
        # window-start pooled mean as the centering point for the moment
        # sums (layout-invariant: one fixed-order reduction per window),
        # over the chains whose log-density is finite
        ok = jnp.isfinite(carry[1])
        ref = psum0(jnp.where(ok[:, None], carry[0], 0.0)) / jnp.maximum(
            psum0(ok.astype(dt)), 1.0)
        carry, _ = run_phase(jax.random.fold_in(k_warm, phase), carry,
                             inv_mass, w, True, ref=ref)
        phase += 1
        U, LP, G, da, s1, s2, n = carry
        # centered-moment variance: s1/s2 accumulate around `ref`, so the
        # subtraction cancels at the scale of the posterior SPREAD, not
        # its location (f32-safe for posteriors far from the origin)
        meanc = s1 / jnp.maximum(n, 1.0)
        var = (s2 - n * meanc * meanc) / jnp.maximum(n - 1.0, 1.0)
        var = jnp.maximum(var, 0.0)
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
        carry = (U, LP, G, da_init(jnp.exp(da["log_eps_bar"])), zeros,
                 zeros, jnp.zeros((), dt))
    if fast2 > 0:
        carry, _ = run_phase(jax.random.fold_in(k_warm, phase), carry,
                             inv_mass, fast2, False)
    U, LP, G, da, *_ = carry
    eps = jnp.exp(da["log_eps_bar"])

    # ---- sampling: same transition at the frozen (eps, inv_mass) ----
    da_fixed = da_init(eps)
    carry = (U, LP, G, da_fixed, zeros, zeros, jnp.zeros((), dt))
    _, (us, logps, aprobs, divs) = run_phase(
        jax.random.fold_in(key, 2), carry, inv_mass, num_samples, False,
        collect=True, adapt_da=False)
    # (samples, chains, ...) -> (chains, samples, ...)
    sw = lambda x: jnp.swapaxes(x, 0, 1)
    return sw(us), sw(logps), sw(aprobs), sw(divs), eps, inv_mass


def hmc_runner(model, args, observed, *, num_samples=1000, num_warmup=500,
               num_chains=1, step_size=0.1, num_leapfrog=16,
               target_accept=0.8, selection=None, init_trace=None,
               pooled_adaptation=None, axis_name=None, setup_key=None):
    """Build a reusable COMPILED HMC sampler: returns ``run(key) -> dict``.

    Setup (initial trace, bijectors) happens once, eagerly, at build time;
    every ``run(key)`` call afterwards is a single jitted program —
    repeated production invocations pay zero retracing/dispatch overhead.
    :func:`hmc` is the one-shot convenience wrapper.
    """
    if init_trace is None:
        init_trace, _ = model.generate(
            setup_key if setup_key is not None else jax.random.PRNGKey(0),
            args, observed)
    logprob, u0, bijectors, constrain = make_unconstrained_logprob(
        model, args, init_trace, observed, selection)
    u0_flat, unravel = ravel_pytree(u0)

    def logprob_flat(u_flat):
        return logprob(unravel(u_flat))

    if pooled_adaptation is None:
        pooled_adaptation = num_chains > 1

    def constrain_flat(u_flat):
        return constrain(unravel(u_flat))

    @jax.jit
    def run(k_run):
        chain_keys = jax.random.split(k_run, num_chains)
        # overdisperse initial points across chains
        jitter = jax.vmap(lambda k: 0.5 * jax.random.normal(
            k, u0_flat.shape, u0_flat.dtype))(chain_keys)
        u0s = u0_flat[None, :] + jitter

        if pooled_adaptation:
            us, logps, aprobs, divs, eps, inv_mass = _pooled_chains(
                jax.random.fold_in(k_run, 0), logprob_flat, u0s, num_warmup,
                num_samples, step_size, num_leapfrog, target_accept,
                axis_name=axis_name)
        else:
            def run_one(k, u0f):
                return _single_chain(k, logprob_flat, u0f, num_warmup,
                                     num_samples, step_size, num_leapfrog,
                                     target_accept)

            us, logps, aprobs, divs, eps, inv_mass = jax.vmap(run_one)(
                chain_keys, u0s)

        # constrain: (chains, samples, dim) -> {addr: (chains, samples, ..)}
        samples = jax.vmap(jax.vmap(constrain_flat))(us)
        return {
            "samples": samples,
            "logp": logps,
            "accept_prob": aprobs,
            "divergences": divs,
            "step_size": eps,
            # adapted diagonal metric M^-1 (Stan's inv_metric): (dim,)
            # shared across chains under pooled adaptation, (chains, dim)
            # on the per-chain path
            "inv_mass": inv_mass,
            "unconstrained": us,
        }

    return run


def hmc(key, model, args, observed, **config):
    """Run adaptive HMC; returns samples in constrained space + diagnostics.

    Chains are vmapped — ``num_chains`` scales to 10^4 on a sharded mesh.
    Samples: {addr: array[(chains, num_samples) + value_shape]}.

    ``pooled_adaptation`` (default: on whenever num_chains > 1) adapts ONE
    shared (step size, inverse mass) from the pooled accept statistics and
    draws of every chain (run_warmup_pooled) instead of per-chain states —
    at 10^4 chains that is 10^4x the adaptation signal per dual-averaging
    update. ``axis_name`` names the mesh axis when run inside shard_map
    (parallel/distributed.shardmap_hmc); the fixed add-tree reduction order
    makes the adapted (eps, inv_mass) bitwise-equal across shardings.

    For repeated invocations build the sampler once with
    :func:`hmc_runner` and call it with fresh keys — each ``hmc()`` call
    re-traces the program.
    """
    k_init, k_run = jax.random.split(key)
    run = hmc_runner(model, args, observed, setup_key=k_init, **config)
    return run(k_run)
