"""MAP estimation and Laplace approximation.

Extension beyond the reference (which has no gradients at all,
modppl/README.md:44): the two standard optimization-based posterior
summaries every production PPL ships (Stan ``optimize``/``laplace``,
numpyro ``AutoLaplaceApproximation``), built on the SAME unconstrained
log-joint machinery as HMC/VI (inference/hmc.make_unconstrained_logprob,
bijectors from per-address distribution support metadata).

Vectorized shape: ``num_restarts`` jittered optimizations run as ONE vmapped
optax.adam ``lax.scan`` (multi-start is a batch axis, not a Python loop),
and the best restart is selected on device. The Hessian for the Laplace
curvature is exact ``jax.hessian`` of the unconstrained log-joint —
d x d for d latents, evaluated once at the mode.

Conventions (matching Stan):

- ``map_optimize`` maximizes the joint density in CONSTRAINED space by
  default (``jacobian=False``) — the returned values are the posterior
  mode of the model's own parameterization. ``jacobian=True`` maximizes
  the Jacobian-adjusted unconstrained density instead (the mode of the
  distribution HMC actually targets).
- ``laplace_approximation`` always uses the Jacobian-adjusted density: it
  is a Gaussian approximation in unconstrained coordinates (samples map
  through the bijectors, so draws respect constraints by construction),
  and its log-normalizer estimates the log marginal likelihood:
  ``log Z ~= logp(u*) + d/2 log(2 pi) + 1/2 log det Sigma``.
"""

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

from modppl_tpu.inference.hmc import make_unconstrained_logprob


def _make_objective(model, args, trace, observed, selection,
                    include_jacobian):
    """Flat unconstrained objective u_flat -> scalar, plus (u0_flat,
    constrain_flat) — hmc.make_unconstrained_logprob (one shared bijector
    / observe / assess composition across HMC, VI and MAP) raveled to a
    flat coordinate vector, with the log-det-Jacobian term optional
    (constrained-space MAP excludes it; the Laplace / HMC-target density
    includes it)."""
    logprob, u0, _, constrain = make_unconstrained_logprob(
        model, args, trace, observed, selection,
        include_jacobian=include_jacobian)
    u0_flat, unravel = ravel_pytree(u0)

    def objective_flat(u_flat):
        return logprob(unravel(u_flat))

    def constrain_flat(u_flat):
        return constrain(unravel(u_flat))

    return objective_flat, u0_flat, constrain_flat


def map_optimize(key, model, args, observed, *, num_steps=500,
                 learning_rate=0.05, num_restarts=8, init_jitter=1.0,
                 jacobian=False, selection=None, init_trace=None,
                 setup_key=None):
    """Posterior mode by vmapped multi-start Adam on the unconstrained
    log-joint. Returns a dict with:

    - ``params``: {addr: value} at the best mode (constrained space);
    - ``unconstrained``: the flat unconstrained optimum;
    - ``logp``: the objective value at the optimum (joint log-density;
      without the Jacobian term unless ``jacobian=True``);
    - ``restart_logps``: (num_restarts,) final values (diagnosing
      multimodality: distinct values = distinct local modes found).
    """
    if init_trace is None:
        init_trace, _ = model.generate(
            setup_key if setup_key is not None else jax.random.PRNGKey(0),
            args, observed)
    objective, u0_flat, constrain_flat = _make_objective(
        model, args, init_trace, observed, selection, jacobian)

    opt = optax.adam(learning_rate)
    value_and_grad = jax.value_and_grad(objective)

    def run_one(u_init):
        state = opt.init(u_init)

        def step(carry, _):
            u, state = carry
            val, g = value_and_grad(u)
            updates, state = opt.update(-g, state)  # ascent
            return (optax.apply_updates(u, updates), state), val

        (u, _), _ = jax.lax.scan(step, (u_init, state), None,
                                 length=num_steps)
        return u, objective(u)

    @jax.jit
    def solve(k):
        jitter = init_jitter * jax.random.normal(
            k, (num_restarts,) + u0_flat.shape, u0_flat.dtype)
        inits = u0_flat[None, :] + jitter.reshape(num_restarts, -1)
        inits = inits.at[0].set(u0_flat)  # restart 0 = the trace's values
        us, vals = jax.vmap(run_one)(inits)
        # a diverged restart carries nan, which argmax treats as maximal
        # — demote non-finite restarts so a converged mode wins
        best = jnp.argmax(jnp.where(jnp.isfinite(vals), vals, -jnp.inf))
        return us[best], vals[best], vals

    u_best, logp, restart_logps = solve(key)
    return {
        "params": constrain_flat(u_best),
        "unconstrained": u_best,
        "logp": logp,
        "restart_logps": restart_logps,
    }


def laplace_approximation(key, model, args, observed, *, num_steps=500,
                          learning_rate=0.05, num_restarts=8,
                          init_jitter=1.0, selection=None, init_trace=None,
                          setup_key=None):
    """Gaussian (Laplace) posterior approximation in unconstrained space.

    Finds the mode of the Jacobian-adjusted unconstrained log-joint (the
    density HMC targets), then curves it with the exact Hessian. Returns
    a dict with:

    - ``mean`` / ``cov`` / ``chol``: the Gaussian in unconstrained space;
    - ``log_ml``: the Laplace estimate of the log marginal likelihood;
    - ``logp``: the log-joint at the mode;
    - ``params``: {addr: value} at the mode (constrained space);
    - ``sample(key, n)``: draws n samples, returned as an {addr: value}
      dict in CONSTRAINED space (leading axis n).
    """
    if init_trace is None:
        init_trace, _ = model.generate(
            setup_key if setup_key is not None else jax.random.PRNGKey(0),
            args, observed)
    objective, u0_flat, constrain_flat = _make_objective(
        model, args, init_trace, observed, selection, True)

    out = map_optimize(key, model, args, observed, num_steps=num_steps,
                       learning_rate=learning_rate,
                       num_restarts=num_restarts, init_jitter=init_jitter,
                       jacobian=True, selection=selection,
                       init_trace=init_trace, setup_key=setup_key)
    u_star = out["unconstrained"]
    d = u_star.shape[0]

    H = jax.hessian(objective)(u_star)
    H = 0.5 * (H + H.T)
    # cov = (-H)^-1 via a Cholesky of the (PD at a strict mode) precision
    L_prec = jnp.linalg.cholesky(-H)
    # a non-PD Hessian (saddle / flat direction / under-converged Adam)
    # makes the whole approximation nan — fail loudly when running
    # eagerly instead of handing back silent nan cov/log_ml/samples
    try:
        if not bool(jnp.all(jnp.isfinite(L_prec))):
            raise ValueError(
                "laplace_approximation: the Hessian at the optimum is not "
                "negative-definite (saddle point, flat direction, or "
                "under-converged optimization — try more num_steps or a "
                "smaller learning_rate)")
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError):
        pass  # under an outer trace the caller must check isfinite(cov)
    eye = jnp.eye(d, dtype=u_star.dtype)
    Linv = jax.scipy.linalg.solve_triangular(L_prec, eye, lower=True)
    cov = Linv.T @ Linv
    chol = jnp.linalg.cholesky(cov)
    logdet_cov = -2.0 * jnp.sum(jnp.log(jnp.diagonal(L_prec)))
    log_ml = (out["logp"] + 0.5 * d * jnp.log(2.0 * jnp.pi)
              + 0.5 * logdet_cov)

    def sample(k, n):
        z = jax.random.normal(k, (n, d), u_star.dtype)
        us = u_star[None, :] + z @ chol.T
        return jax.vmap(constrain_flat)(us)

    return {
        "mean": u_star,
        "cov": cov,
        "chol": chol,
        "log_ml": log_ml,
        "logp": out["logp"],
        "params": constrain_flat(u_star),
        "restart_logps": out["restart_logps"],
        "sample": sample,
    }
