"""ChEES-HMC: jittered fixed-length trajectories with pooled adaptation.

The many-chain alternative to NUTS (VERDICT r4 #2). NUTS builds a
per-chain binary tree under a vmapped ``while_loop``: every chain pays the
BATCH-MAX tree depth each transition (a counted x4.9 serialization at 2048
chains), and the checkpoint stacks cost O(max_depth · d) memory per
chain. ChEES (Hoffman, Radul & Sountsov,
AISTATS 2021, "An Adaptive MCMC Scheme for Setting Trajectory Lengths in
Hamiltonian Monte Carlo") replaces the per-chain U-turn criterion with ONE
shared trajectory length adapted from cross-chain statistics:

- each iteration runs ``L_t = ceil(h_t · τ / ε)`` leapfrog steps, where
  ``h_t`` is a shared Halton-sequence jitter in (0, 1] — a SCALAR, so all
  chains march in lockstep (uniform control flow, full SIMD utilization;
  the ``fori_loop`` trip count is dynamic but chain-independent);
- τ maximizes the ChEES criterion  E[(‖x' − E x'‖² − ‖x − E x‖²)²]/4  by
  Adam on log τ, with the gradient estimated from accept-weighted
  per-chain statistics pooled across all chains (and shards);
- step size ε adapts by the same pooled dual averaging as HMC
  (inference/hmc.da_update), diagonal mass by the same windowed
  Chan-Welford schedule (inference/adaptation.warmup_schedule).

Like the round-5 fast HMC path (hmc._pooled_chains) this pre-draws each
segment's randoms keyed by GLOBAL chain index and reduces with fixed add
trees, so results are bitwise layout-invariant across dp shardings.

No reference counterpart (the reference has no gradient inference at all);
extension target per BASELINE.json north star ("extend to NUTS/HMC").
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from modppl_tpu.inference.hmc import (
    _PREDRAW_SEG,
    da_init,
    da_update,
    make_unconstrained_logprob,
)


def halton(n, base=2):
    """First n terms of the base-``base`` Halton (radical-inverse) sequence,
    in (0, 1). Deterministic, low-discrepancy — the trajectory jitter
    recommended by the ChEES paper (breaks periodic-orbit resonance
    without the variance of iid jitter)."""
    out = np.zeros(n)
    for i in range(n):
        f, r, x = 1.0, 0.0, i + 1
        while x > 0:
            f /= base
            r += f * (x % base)
            x //= base
        out[i] = r
    return out


def _adam_init(log_tau0):
    return {"log_tau": jnp.asarray(log_tau0), "m": jnp.zeros(()),
            "v": jnp.zeros(()), "t": jnp.zeros(())}


def _adam_update(st, grad, lr, beta1=0.9, beta2=0.95, eps=1e-8):
    t = st["t"] + 1.0
    m = beta1 * st["m"] + (1.0 - beta1) * grad
    v = beta2 * st["v"] + (1.0 - beta2) * grad * grad
    mh = m / (1.0 - beta1 ** t)
    vh = v / (1.0 - beta2 ** t)
    # gradient ASCENT on the ChEES criterion
    log_tau = st["log_tau"] + lr * mh / (jnp.sqrt(vh) + eps)
    return {"log_tau": log_tau, "m": m, "v": v, "t": t}


def _phase_randoms(phase_key, gidx, length, dim, dtype):
    """Pre-drawn per-segment randoms (momenta + accept uniforms), keyed by
    global chain index — hmc._phase_randoms minus the step-size jitter
    (ChEES jitters the trajectory LENGTH, via the shared Halton stream)."""

    def per_chain(i):
        k = jax.random.fold_in(phase_key, i)
        mom = jax.random.normal(jax.random.fold_in(k, 0), (length, dim),
                                dtype)
        acc = jax.random.uniform(jax.random.fold_in(k, 2), (length,), dtype)
        return mom, acc

    mom, acc = jax.vmap(per_chain)(gidx)
    return jnp.swapaxes(mom, 0, 1), jnp.swapaxes(acc, 0, 1)


def _chees_transition(vag, U, LP, G, eps, num_steps, inv_mass, mom_t,
                      acc_t, max_leapfrog, static_unroll=None):
    """One whole-batch jittered-HMC transition; ``num_steps`` is a traced
    SCALAR shared by every chain (the ChEES design point: a chain-uniform
    ``fori_loop``, not a vmapped per-chain ``while_loop``).

    ``static_unroll`` (round 5, late): run a STATIC, Python-unrolled loop
    of that many leapfrog steps, each masked by ``i < num_steps`` (steps
    past the jittered count recompute the frozen state and are selected
    away). A dynamic ``fori_loop`` trip is a dispatch boundary per step —
    at small d the whole transition is launch-bound (~24 us per gradient
    evaluation measured on the d=3 hierarchical leg, vs ~4 us when XLA
    can fuse across steps) — so paying <= 2x masked FLOPs for a fully
    fused trajectory is a large net win. The step count is clamped to
    ``static_unroll`` (the same capping semantics ``max_leapfrog`` already
    has).

    Returns (U', LP', G', aprob, divergent, u_prop, p_end) — the proposal
    state and end momentum feed the ChEES gradient estimate.
    """
    eps_c = eps
    p0 = mom_t / jnp.sqrt(inv_mass)[None, :]
    h0 = -LP + 0.5 * jnp.sum(inv_mass[None, :] * p0 * p0, -1)

    def lf(_, carry):
        u, p, lp, g = carry
        p = p + 0.5 * eps_c * g
        u = u + eps_c * inv_mass[None, :] * p
        lp, g = vag(u)
        p = p + 0.5 * eps_c * g
        return u, p, lp, g

    if static_unroll is None:
        n = jnp.clip(num_steps, 1, max_leapfrog)
        u, p, lp, g = jax.lax.fori_loop(0, n, lf, (U, p0, LP, G))
    else:
        n = jnp.clip(num_steps, 1, static_unroll)
        carry = (U, p0, LP, G)
        for i in range(static_unroll):
            new = lf(i, carry)
            pred = i < n
            carry = jax.tree_util.tree_map(
                lambda a, b: jnp.where(pred, a, b), new, carry)
        u, p, lp, g = carry
    h1 = -lp + 0.5 * jnp.sum(inv_mass[None, :] * p * p, -1)
    delta_h = h0 - h1
    divergent = ~jnp.isfinite(delta_h) | (delta_h < -1000.0)
    aprob = jnp.where(divergent, 0.0, jnp.minimum(1.0, jnp.exp(delta_h)))
    acc = acc_t < aprob
    U_out = jnp.where(acc[:, None], u, U)
    LP_out = jnp.where(acc, lp, LP)
    G_out = jnp.where(acc[:, None], g, G)
    return U_out, LP_out, G_out, aprob, divergent, u, p


def chees_runner(model, args, observed, *, num_samples=1000, num_warmup=500,
                 num_chains=2, step_size=0.1, init_traj_length=None,
                 target_accept=0.75, max_leapfrog=1000, adam_lr=0.025,
                 static_unroll=None, selection=None, init_trace=None,
                 axis_name=None, setup_key=None):
    """Build a reusable COMPILED ChEES-HMC sampler: ``run(key) -> dict``.

    Output contract follows hmc_runner, plus ``trajectory_length`` (the
    adapted τ) and ``num_leapfrog`` (per-iteration step counts of the
    sampling phase). ``target_accept`` defaults to 0.75 (jittered
    fixed-length HMC tolerates a slightly lower rate than NUTS's 0.8).

    ``static_unroll=K`` caps trajectories at K steps and runs them as a
    masked static unroll (one fused XLA region per transition instead of
    a dispatch per leapfrog step — see :func:`_chees_transition`). Pick K
    around the expected τ/ε (the jittered mean step count is τ/(2ε));
    when the adapted trajectory wants more than K steps the cap binds,
    exactly as ``max_leapfrog`` would.
    """
    if num_chains < 2:
        raise ValueError("chees: pooled trajectory adaptation needs "
                         "num_chains >= 2 (the criterion is a cross-chain "
                         "variance)")
    if init_trace is None:
        init_trace, _ = model.generate(
            setup_key if setup_key is not None else jax.random.PRNGKey(0),
            args, observed)
    logprob, u0, bijectors, constrain = make_unconstrained_logprob(
        model, args, init_trace, observed, selection)
    u0_flat, unravel = ravel_pytree(u0)
    dim = u0_flat.shape[0]
    dt = u0_flat.dtype

    def logprob_flat(u_flat):
        return logprob(unravel(u_flat))

    vag = jax.vmap(jax.value_and_grad(logprob_flat))

    def constrain_flat(u_flat):
        return constrain(unravel(u_flat))

    from modppl_tpu.inference.adaptation import _pooled_sum, warmup_schedule

    tau0 = (float(init_traj_length) if init_traj_length is not None
            else max(8.0 * step_size, 0.5))
    fast1, slow, fast2 = warmup_schedule(num_warmup)
    # shared Halton jitter streams, one entry per iteration (host-side)
    h_warm = jnp.asarray(halton(num_warmup), dt) if num_warmup else None
    # sampling keeps jittering (it is part of the kernel, not adaptation):
    h_samp = jnp.asarray(halton(num_samples), dt)

    def chains(k_run, u0s):
        """Core pipeline over pre-built initial positions — exposed (as
        ``run.chains``) so parallel/distributed.shardmap_chees can run the
        IDENTICAL body per shard with ``axis_name`` collectives. Returns
        the raw stacks (us, logps, aprobs, divs, nsteps, eps, tau),
        chains-major."""
        c_local = u0s.shape[0]
        if axis_name is None:
            c_total = jnp.asarray(float(c_local), dt)
            gidx = jnp.arange(c_local)
        else:
            c_total = jnp.asarray(float(c_local), dt) * jax.lax.psum(
                jnp.ones((), dt), axis_name)
            gidx = jax.lax.axis_index(axis_name) * c_local \
                + jnp.arange(c_local)

        def pooled_mean(x):
            return _pooled_sum(x, axis_name) / c_total

        def make_body(inv_mass, adapt_mass, adapt, h_stream, collect):
            def body(carry, xs):
                (U, LP, G, da, adam, mean, m2, n) = \
                    jax.lax.optimization_barrier(carry)
                mom_t, acc_t, it = xs
                h_t = h_stream[it]
                eps = jnp.exp(da["log_eps"])
                tau = jnp.exp(adam["log_tau"])
                max_eff = (static_unroll if static_unroll is not None
                           else max_leapfrog)
                num_steps = jnp.clip(
                    jnp.ceil(h_t * tau / eps), 1, max_eff
                ).astype(jnp.int32)
                U2, LP2, G2, aprob, div, u_prop, p_end = _chees_transition(
                    vag, U, LP, G, eps, num_steps, inv_mass, mom_t, acc_t,
                    max_leapfrog, static_unroll=static_unroll)
                U2, LP2, G2, aprob, u_prop, p_end = \
                    jax.lax.optimization_barrier(
                        (U2, LP2, G2, aprob, u_prop, p_end))
                if adapt:
                    # pooled accept stats only while adapting: the frozen
                    # sampling phase would otherwise pay a per-iteration
                    # cross-shard reduction nothing consumes
                    a_sum = _pooled_sum(aprob, axis_name)
                    a_mean = a_sum / c_total
                    da = da_update(da, a_mean, target=target_accept)
                    # keep tau >= 2*eps: if eps outgrows tau the step
                    # count pins at 1 and tau stops affecting the kernel
                    # — its gradient becomes pure noise and the
                    # adaptation decouples (measured: eps 16.9, tau
                    # 0.056, 1-step trajectories on a 1-D target).
                    # Raising TAU (not suppressing eps — an earlier
                    # eps-capping variant pinned eps below its dual-
                    # averaging equilibrium and starved the whole
                    # sampler: accept 0.97 at target 0.75, 1.5-step
                    # trajectories, 6% ESS efficiency) keeps DA free and
                    # guarantees >= 2 steps so the criterion gradient
                    # stays informative.
                    floor = da["log_eps"] + jnp.log(2.0)
                    adam = dict(adam, log_tau=jnp.maximum(
                        adam["log_tau"], floor))
                    # ChEES gradient wrt τ (paper eq. 14, accept-weighted):
                    #   ĝ = Σ_c A_c (‖u'_c−ū'‖² − ‖u_c−ū‖²)·⟨u'_c−ū', p'_c⟩
                    #       / Σ_c A_c · h_t
                    # divergent chains carry inf/nan positions: mask them
                    # out BEFORE the products (0 * inf = nan would poison
                    # the pooled criterion and stick tau at nan forever)
                    fin = ~div & jnp.all(jnp.isfinite(u_prop), -1) \
                        & jnp.all(jnp.isfinite(p_end), -1)
                    u_safe = jnp.where(fin[:, None], u_prop, 0.0)
                    p_safe = jnp.where(fin[:, None], p_end, 0.0)
                    ubar = pooled_mean(U)
                    n_fin = jnp.maximum(
                        _pooled_sum(fin.astype(u_prop.dtype), axis_name),
                        1.0)
                    ubar_p = _pooled_sum(u_safe, axis_name) / n_fin
                    d_prev = jnp.sum((U - ubar[None, :]) ** 2, -1)
                    cent = u_safe - ubar_p[None, :]
                    d_prop = jnp.sum(cent * cent, -1)
                    proj = jnp.sum(cent * (inv_mass[None, :] * p_safe), -1)
                    per_chain = jnp.where(
                        fin, aprob * (d_prop - d_prev) * proj, 0.0)
                    g_num = _pooled_sum(per_chain, axis_name)
                    grad = h_t * g_num / jnp.maximum(a_sum, 1e-6)
                    # normalize scale so Adam's lr is problem-independent
                    grad = grad / (1.0 + jnp.abs(grad))
                    grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
                    adam = _adam_update(adam, grad, adam_lr)
                    # STATIC τ bounds. An earlier eps-tied clip
                    # (log eps .. log eps·max_leapfrog) was a real bug:
                    # when dual averaging crashes eps early in warmup
                    # (normal for a too-large step_size), the clip
                    # dragged τ down with it and both recovered too
                    # slowly — measured eps 100x under-adapted on the
                    # hierarchical bench leg (accept 0.96 at target 0.75,
                    # 137-step trajectories). num_steps is already
                    # bounded by max_leapfrog at use time.
                    adam = dict(adam, log_tau=jnp.clip(
                        adam["log_tau"],
                        jnp.log(jnp.asarray(1e-3, dt)),
                        jnp.log(jnp.asarray(1e3, dt))))
                if adapt_mass:
                    b_mean = pooled_mean(U2)
                    b_m2 = _pooled_sum((U2 - b_mean[None]) ** 2, axis_name)
                    n_new = n + c_total
                    delta = b_mean - mean
                    mean = mean + delta * c_total / n_new
                    m2 = m2 + b_m2 + delta * delta * n * c_total / n_new
                    n = n_new
                if collect == "debug":
                    if not adapt:  # a_mean only exists while adapting
                        a_mean = _pooled_sum(aprob, axis_name) / c_total
                    ys = (a_mean, da["log_eps"], adam["log_tau"],
                          num_steps)
                elif collect:
                    ys = (U2, LP2, aprob, div, num_steps)
                else:
                    ys = None
                return (U2, LP2, G2, da, adam, mean, m2, n), ys

            return body

        zeros = jnp.zeros((dim,), dt)

        def run_phase(phase_key, carry, inv_mass, start, length,
                      adapt_mass, adapt, h_stream, collect=False):
            body = make_body(inv_mass, adapt_mass, adapt, h_stream,
                             collect)
            outs = []
            done, seg = 0, 0
            while done < length:
                k = min(_PREDRAW_SEG, length - done)
                mom, acc = _phase_randoms(
                    jax.random.fold_in(phase_key, seg), gidx, k, dim, dt)
                its = start + done + jnp.arange(k)
                carry, ys = jax.lax.scan(body, carry, (mom, acc, its))
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

        inv_mass = jnp.ones((dim,), dt)
        LP0, G0 = vag(u0s)
        carry = (u0s, LP0, G0, da_init(jnp.asarray(step_size, dt)),
                 _adam_init(jnp.log(tau0)), zeros, zeros,
                 jnp.zeros((), dt))
        k_warm = jax.random.fold_in(k_run, 0)
        phase, start = 0, 0
        if fast1 > 0:
            carry, _ = run_phase(jax.random.fold_in(k_warm, phase), carry,
                                 inv_mass, start, fast1, False, True,
                                 h_warm)
            phase += 1
            start += fast1
        for w in slow:
            carry, _ = run_phase(jax.random.fold_in(k_warm, phase), carry,
                                 inv_mass, start, w, True, True, h_warm)
            phase += 1
            start += w
            U, LP, G, da, adam, mean, m2, n = carry
            var = m2 / jnp.maximum(n - 1.0, 1.0)
            shrink = n / (n + 5.0)
            var = shrink * var + (1.0 - shrink) * 1e-3
            # ROUND-5 FIX: inv_mass is M^-1 in the transition
            # (p ~ N(0, M) is drawn as z/sqrt(inv_mass);
            # u += eps*inv_mass*p), so optimal preconditioning sets it to
            # the VARIANCE estimate (Stan's inv_metric = Sigma), NOT
            # 1/var — see inference/adaptation.py for the measurement
            inv_mass = jnp.clip(var, 1e-8, 1e8)
            carry = (U, LP, G, da_init(jnp.exp(da["log_eps_bar"])), adam,
                     zeros, zeros, jnp.zeros((), dt))
        if fast2 > 0:
            carry, _ = run_phase(jax.random.fold_in(k_warm, phase), carry,
                                 inv_mass, start, fast2, False, True,
                                 h_warm)
        U, LP, G, da, adam, *_ = carry
        eps = jnp.exp(da["log_eps_bar"])
        tau = jnp.exp(adam["log_tau"])

        # sampling: frozen (eps, tau, inv_mass); Halton jitter stays on
        carry = (U, LP, G, da_init(eps), dict(_adam_init(jnp.log(tau)),
                                              log_tau=adam["log_tau"]),
                 zeros, zeros, jnp.zeros((), dt))
        _, (us, logps, aprobs, divs, nsteps) = run_phase(
            jax.random.fold_in(k_run, 2), carry, inv_mass, 0, num_samples,
            False, False, h_samp, collect=True)

        sw = lambda x: jnp.swapaxes(x, 0, 1)
        return (sw(us), sw(logps), sw(aprobs), sw(divs), nsteps, eps, tau)

    @jax.jit
    def _run_jit(k_run):
        chain_keys = jax.random.split(k_run, num_chains)
        jitter = jax.vmap(lambda k: 0.5 * jax.random.normal(
            k, u0_flat.shape, dt))(chain_keys)
        u0s = u0_flat[None, :] + jitter
        us, logps, aprobs, divs, nsteps, eps, tau = chains(k_run, u0s)
        samples = jax.vmap(jax.vmap(constrain_flat))(us)
        return {
            "samples": samples,
            "logp": logps,
            "accept_prob": aprobs,
            "divergences": divs,
            "step_size": eps,
            "trajectory_length": tau,
            "num_leapfrog": nsteps,
            "unconstrained": us,
        }

    def run(k_run):
        return _run_jit(k_run)

    run.chains = chains
    run.constrain_flat = constrain_flat
    run.u0_flat = u0_flat
    return run


def chees(key, model, args, observed, **config):
    """One-shot ChEES-HMC (see :func:`chees_runner` for the contract)."""
    k_init, k_run = jax.random.split(key)
    run = chees_runner(model, args, observed, setup_key=k_init, **config)
    return run(k_run)
