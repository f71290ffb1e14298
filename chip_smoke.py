"""Smoke run of the inference engine on NVIDIA GPUs.

Drives each main entry point once, through the calls a user makes, at the
sizes ``bench.py`` uses, and checks every result against a float64 NumPy
reference computed on the host:

    python chip_smoke.py          # every one-card phase
    python chip_smoke.py --four   # only the sharded SMC filter and pooled
                                  # HMC on four GPUs, each compared bitwise
                                  # with the same call on one device

Each phase prints one JSON line: the card, compile and run seconds, peak
device memory, and its checks (value, tolerance, reason, pass). The script
refuses to run without a GPU, stops at the first failed phase, and prints
``{"ok": true, "device": {...}}`` as its last line only when every phase
passed. One process drives every card it uses.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Monte Carlo checks fail above K_MCSE Monte Carlo standard errors: a
# correct sampler exceeds 5 MCSE with probability < 1e-6 per quantity
# under the central limit theorem.
K_MCSE = 5.0
MCSE_REASON = ("Monte Carlo error: |estimate - exact| / MCSE, MCSE from "
               "Geyer's ESS; a correct sampler exceeds 5 with p < 1e-6")


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def _compile_and_run(fn, *args):
    """Compile ``fn`` for ``args``, then time one run to completion."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t2 = time.perf_counter()
    mem = compiled.memory_analysis()
    peak = None
    if mem is not None:
        peak = int(mem.temp_size_in_bytes + mem.argument_size_in_bytes
                   + mem.output_size_in_bytes - mem.alias_size_in_bytes)
    return out, {"compile_s": t1 - t0, "run_s": t2 - t1,
                 "program_bytes": peak}


def _check(name, value, tol, reason, passed=None):
    """One check: ``value`` must be finite and at most ``tol`` unless
    ``passed`` is given."""
    value = float(value)
    if passed is None:
        passed = math.isfinite(value) and value <= tol
    return {"name": name, "value": value, "tol": tol, "reason": reason,
            "pass": bool(passed)}


def _record(phase, timing, checks):
    rec = {"phase": phase, **timing, "checks": checks}
    stats = jax.devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        rec["device_peak_bytes"] = int(stats["peak_bytes_in_use"])
    rec["ok"] = all(c["pass"] for c in checks)
    return rec


def _moment_checks(label, draws, mean, var):
    """Per-coordinate mean and variance of ``draws`` (chains, n, d) against
    the exact ``mean``/``var``, as the worst |error| / MCSE."""
    from modppl_tpu.utils.diagnostics import ess_autocorr

    draws = np.asarray(draws, np.float64)
    z_mean, z_var = [], []
    for j in range(draws.shape[-1]):
        x = draws[..., j]
        mcse = x.std() / math.sqrt(ess_autocorr(x))
        z_mean.append(abs(x.mean() - mean[j]) / mcse)
        sq = (x - mean[j]) ** 2     # unbiased for var at the exact mean
        mcse_sq = sq.std() / math.sqrt(ess_autocorr(sq))
        z_var.append(abs(sq.mean() - var[j]) / mcse_sq)
    return [
        _check(f"{label} mean: max |err|/MCSE", max(z_mean), K_MCSE,
               MCSE_REASON),
        _check(f"{label} variance: max |err|/MCSE", max(z_var), K_MCSE,
               MCSE_REASON),
    ]


# --------------------------------------------------------------------------
# host references (float64 NumPy)
# --------------------------------------------------------------------------

def _hierarchical_data():
    """The bench's hierarchical-regression data, quadratic branch
    observed: the (a, b, c) posterior is Gaussian in closed form."""
    from modppl_tpu import Trie
    from modppl_tpu.models.hierarchical_static import (
        NOISE,
        exact_hierarchical_posterior,
        make_hierarchical_static,
    )

    n_points = 10
    xs = np.linspace(-1.0, 1.0, n_points)
    ys = (0.3 + 0.5 * xs - 0.8 * xs * xs
          + NOISE * np.random.default_rng(0).standard_normal(n_points))
    model = make_hierarchical_static(n_points)
    observed = Trie.from_dict({"ys": jnp.asarray(ys, jnp.float32),
                               "is_linear": False})
    _, _, _, m_quad, c_quad, _ = exact_hierarchical_posterior(xs, ys)
    return model, (jnp.asarray(xs, jnp.float32),), observed, m_quad, \
        np.diag(c_quad)


def _hierarchical_draws(out):
    """(chains, draws, 3) stack of coeffs a, b, c (addresses sort so)."""
    s = sorted(out["samples"].items(), key=lambda kv: str(kv[0]))
    return np.stack([np.asarray(v) for _, v in s], axis=-1)


def _laplace_sd(X, ys, w):
    """Posterior sd of the logistic regression's Laplace approximation at
    the MAP ``w`` (standard-normal prior)."""
    X = np.asarray(X, np.float64)
    p = 1.0 / (1.0 + np.exp(-X @ w))
    H = (X.T * (p * (1.0 - p))) @ X + np.eye(X.shape[1])
    return np.sqrt(np.diag(np.linalg.inv(H)))


LG_A, LG_Q, LG_R = 0.9, 0.5, 0.3


def kalman_log_ml(ys, a=LG_A, q=LG_Q, r=LG_R):
    """Exact log p(y_1:T) of x_0 ~ N(0, 1), x_t ~ N(a x_{t-1}, q^2),
    y_t ~ N(x_t, r^2)."""
    mu, var, total = 0.0, 1.0, 0.0
    for t, y in enumerate(np.asarray(ys, np.float64)):
        if t > 0:
            mu, var = a * mu, a * a * var + q * q
        s = var + r * r
        total += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k = var / s
        mu, var = mu + k * (y - mu), (1.0 - k) * var
    return total


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------

def phase_is_flagship():
    """Importance sampling on the flagship model through
    ``__graft_entry__.entry()``, against the conjugate posterior of c."""
    from __graft_entry__ import entry
    from modppl_tpu.models.hierarchical_static import (
        exact_hierarchical_posterior,
    )

    forward, args = entry()
    (log_ml, post_c), timing = _compile_and_run(forward, *args)
    xs = np.linspace(-5.0, 5.0, 8)
    p_lin, _, _, m_quad, _, _ = exact_hierarchical_posterior(
        xs, 0.3 + 0.4 * xs + 0.5 * xs * xs)
    # c is a prior-scored N(0, 1) auxiliary on the linear branch
    exact_c = (1.0 - p_lin) * m_quad[2]
    return _record("is_flagship", timing, [
        _check("log_ml finite", log_ml, math.inf, "finite estimate",
               passed=np.isfinite(float(log_ml))),
        _check("|E[c] - exact|", abs(float(post_c) - exact_c), 0.25,
               "IS from the prior at 1024 particles has ESS ~ 1 here, so "
               "the estimate is the best prior draw's c; over 50 seeds "
               "|err| <= 0.115 in a CPU run"),
    ])


def _spiral_constraints(num_steps):
    from modppl_tpu import Trie

    obs = [jnp.array([0.4 * np.cos(2 * np.pi * t / 16.0),
                      0.4 * np.sin(2 * np.pi * t / 16.0)], jnp.float32)
           for t in range(num_steps)]
    init_c = Trie.from_dict({"obs": obs[0]})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[Trie.from_dict({"obs": o}) for o in obs[1:]])
    return init_c, step_c


def phase_smc_bootstrap(num_particles=1 << 20, num_steps=10):
    """Bootstrap filter on the spiral-tracking model (the bench's SMC
    headline), one card, resampling every step."""
    from modppl_tpu.models.spiral import spiral_scan_kernel
    from modppl_tpu.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    kernel = spiral_scan_kernel()
    init_c, step_c = _spiral_constraints(num_steps)

    def run(key, init_c, step_c):
        out = sharded_batched_particle_filter(
            None, key, kernel, jnp.zeros(2, jnp.float32), init_c, step_c,
            num_particles, ess_threshold=1.0, auto_batch=True,
            store_ancestry=False)
        return out["log_ml"], out["ess"]

    (log_ml, ess), timing = _compile_and_run(run, jax.random.PRNGKey(1),
                                             init_c, step_c)
    ess = np.asarray(ess)
    return _record("smc_bootstrap", timing, [
        _check("log_ml finite", log_ml, math.inf, "finite estimate",
               passed=np.isfinite(float(log_ml))),
        _check("min ESS over steps", ess.min(), math.inf,
               "ESS must be > 0 at every step",
               passed=bool(np.all(ess > 0))),
    ])


def _lg_guided_model():
    """Scalar linear-Gaussian SSM with its locally optimal proposal."""
    from modppl_tpu import gen, normal

    @gen
    def lg_init(h, _s0):
        x = h.sample(normal, (0.0, 1.0), "x")
        h.sample(normal, (x, LG_R), "y")
        return x

    @gen
    def lg_step(h, t, prev):
        x = h.sample(normal, (LG_A * prev, LG_Q), "x")
        h.sample(normal, (x, LG_R), "y")
        return x

    @gen
    def lg_prop(h, t, prev, cons):
        y = cons.read("y")
        prec = 1.0 / LG_Q ** 2 + 1.0 / LG_R ** 2
        m = (LG_A * prev / LG_Q ** 2 + y / LG_R ** 2) / prec
        h.sample(normal, (m, 1.0 / jnp.sqrt(prec)), "x")

    return lg_init, lg_step, lg_prop


def phase_smc_guided(num_particles=1 << 20, num_steps=10):
    """Guided filter (locally optimal proposal + one rejuvenation move per
    step) against the exact Kalman log marginal likelihood."""
    from modppl_tpu import Trie, select
    from modppl_tpu.inference.vsmc import ScanKernel
    from modppl_tpu.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    lg_init, lg_step, lg_prop = _lg_guided_model()
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal()]
    for _ in range(num_steps - 1):
        xs.append(LG_A * xs[-1] + LG_Q * rng.standard_normal())
    ys = np.asarray([x + LG_R * rng.standard_normal() for x in xs],
                    np.float32)
    init_c = Trie.from_dict({"y": jnp.asarray(ys[0])})
    step_c = jax.tree_util.tree_map(
        lambda *v: jnp.stack(v),
        *[Trie.from_dict({"y": jnp.asarray(y)}) for y in ys[1:]])
    kernel = ScanKernel(lg_init, lg_step)

    def run(key, init_c, step_c):
        return sharded_batched_particle_filter(
            None, key, kernel, jnp.zeros(()), init_c, step_c,
            num_particles, ess_threshold=1.0, auto_batch=True,
            store_ancestry=False, proposal=lg_prop,
            rejuvenation=(select("x"), 1))["log_ml"]

    log_ml, timing = _compile_and_run(run, jax.random.PRNGKey(1), init_c,
                                      step_c)
    err = abs(float(log_ml) - kalman_log_ml(ys))
    return _record("smc_guided", timing, [
        _check("|log_ml - Kalman|", err, 0.02 * math.sqrt(
            (1 << 20) / num_particles),
            "Monte Carlo error: the log-ML sd is 0.016 at 2^14 particles "
            "over 8 seeds in a CPU run, ~2e-3 at 2^20 (N^-1/2); tol is "
            "~10 sd, 0.02 scaled by sqrt(2^20/N)"),
    ])


def phase_hmc_d3(num_chains=10_000, num_warmup=300, num_samples=500):
    """Pooled-adaptation HMC on the hierarchical regression (d = 3)."""
    from modppl_tpu.inference.hmc import hmc_runner

    model, args, observed, mean, var = _hierarchical_data()
    run = hmc_runner(model, args, observed, num_samples=num_samples,
                     num_warmup=num_warmup, num_chains=num_chains,
                     num_leapfrog=8, setup_key=jax.random.PRNGKey(99))
    out, timing = _compile_and_run(run, jax.random.PRNGKey(0))
    return _record("hmc_d3", timing, _moment_checks(
        "(a, b, c)", _hierarchical_draws(out), mean, var))


def _logreg_data(key, n_data, dim):
    from modppl_tpu.models.logreg import map_newton, simulate_logreg

    X, ys, _ = simulate_logreg(key, n_data, dim)
    w_map = map_newton(X, ys)
    return X, ys, w_map, _laplace_sd(X, ys, w_map)


def phase_hmc_logreg(num_chains=10_000, num_warmup=300, num_samples=500,
                     dim=16, n_data=128):
    """Pooled HMC on Bayesian logistic regression (the non-quadratic
    generic path), posterior mean against the Newton MAP."""
    from modppl_tpu import Trie
    from modppl_tpu.inference.hmc import hmc_runner
    from modppl_tpu.models.logreg import make_logreg

    X, ys, w_map, sd = _logreg_data(jax.random.PRNGKey(42), n_data, dim)
    run = hmc_runner(make_logreg(dim), (X, ys), Trie(),
                     num_samples=num_samples, num_warmup=num_warmup,
                     num_chains=num_chains, num_leapfrog=4,
                     setup_key=jax.random.PRNGKey(99))
    out, timing = _compile_and_run(run, jax.random.PRNGKey(0))
    w = np.asarray(out["unconstrained"], np.float64).reshape(-1, dim)
    dist = np.max(np.abs(w.mean(0) - w_map) / sd)
    return _record("hmc_logreg", timing, [
        _check("max |E[w] - MAP| / Laplace sd", dist, 1.0,
               "a logistic posterior at n/d = 8 is skewed: its mean sits "
               "0.61 Laplace sd from the mode in a float64 CPU run"),
        _check("accept rate", np.asarray(out["accept_prob"]).mean(), 1.0,
               "dual averaging targets 0.8; below 0.5 means the step size "
               "failed to adapt",
               passed=np.asarray(out["accept_prob"]).mean() > 0.5),
    ])


def phase_hmc_d128(num_chains=4096, num_warmup=300, num_samples=256,
                   dim=128, cond=1e4):
    """Pooled HMC on the rotated ill-conditioned Gaussian N(0, Σ)."""
    from modppl_tpu import Trie
    from modppl_tpu.inference.hmc import hmc_runner
    from modppl_tpu.models.illcond_gauss import illcond_cov, \
        make_illcond_gauss

    run = hmc_runner(make_illcond_gauss(dim, cond), (), Trie(),
                     num_samples=num_samples, num_warmup=num_warmup,
                     num_chains=num_chains, num_leapfrog=32,
                     setup_key=jax.random.PRNGKey(99))
    out, timing = _compile_and_run(run, jax.random.PRNGKey(0))
    # the model's own float32 covariance is the target's exact covariance
    var = np.diag(np.asarray(illcond_cov(dim, cond), np.float64))
    return _record("hmc_d128", timing, _moment_checks(
        "x", out["unconstrained"], np.zeros(dim), var))


def phase_nuts(num_chains=10_000, num_warmup=200, num_samples=300):
    """Pooled-adaptation NUTS on the hierarchical regression."""
    from modppl_tpu.inference.nuts import nuts_runner

    model, args, observed, mean, var = _hierarchical_data()
    run = nuts_runner(model, args, observed, num_samples=num_samples,
                      num_warmup=num_warmup, num_chains=num_chains,
                      max_depth=6, setup_key=jax.random.PRNGKey(99))
    out, timing = _compile_and_run(run, jax.random.PRNGKey(0))
    return _record("nuts", timing, _moment_checks(
        "(a, b, c)", _hierarchical_draws(out), mean, var))


def phase_chees(num_chains=10_000, num_warmup=200, num_samples=300):
    """ChEES-HMC on the hierarchical regression."""
    from modppl_tpu.inference.chees import chees_runner

    model, args, observed, mean, var = _hierarchical_data()
    run = chees_runner(model, args, observed, num_samples=num_samples,
                       num_warmup=num_warmup, num_chains=num_chains,
                       setup_key=jax.random.PRNGKey(99))
    out, timing = _compile_and_run(run, jax.random.PRNGKey(0))
    return _record("chees", timing, _moment_checks(
        "(a, b, c)", _hierarchical_draws(out), mean, var))


def phase_advi(num_steps=2000, num_mc=1024, dim=16, n_data=256):
    """Mean-field ADVI on the logistic regression."""
    from modppl_tpu import Trie
    from modppl_tpu.inference.vi import advi
    from modppl_tpu.models.logreg import make_logreg

    X, ys, w_map, sd = _logreg_data(jax.random.PRNGKey(7), n_data, dim)
    model = make_logreg(dim)

    def run(key):
        # learning rate 0.05: at the bench's 5e-3 the 30x-decayed Adam
        # steps sum to ~2.8 units, too little to reach the optimum from
        # a prior draw in 2000 steps
        out = advi(key, model, (X, ys), Trie(), num_steps=num_steps,
                   num_mc=num_mc, learning_rate=5e-2)
        return out["mu"], out["elbo"]

    (mu, elbo), timing = _compile_and_run(run, jax.random.PRNGKey(0))
    elbo = np.asarray(elbo, np.float64)
    k = max(1, num_steps // 40)
    gain = elbo[-k:].mean() - elbo[:k].mean()
    dist = np.max(np.abs(np.asarray(mu, np.float64) - w_map) / sd)
    return _record("advi", timing, [
        _check("final ELBO - initial ELBO", gain, math.inf,
               "the optimizer must raise the ELBO", passed=gain > 0),
        _check("max |mu - MAP| / Laplace sd", dist, 1.0,
               "the mean-field mean sits at the skewed posterior's bulk, "
               "0.54 Laplace sd from the mode in a CPU run"),
    ])


PHASES = [phase_is_flagship, phase_smc_bootstrap, phase_smc_guided,
          phase_hmc_d3, phase_hmc_logreg, phase_hmc_d128, phase_nuts,
          phase_chees, phase_advi]


# --------------------------------------------------------------------------
# four-card phases: sharded vs one device, bitwise
# --------------------------------------------------------------------------

BITWISE_REASON = ("determinism contract (docs/parallelism.md): any "
                  "power-of-two layout gives identical bits")


def _mismatches(a, b):
    return int(np.sum(np.asarray(a) != np.asarray(b)))


def phase_sharded_smc(devices, num_particles=1 << 22, num_steps=10):
    """The sharded bootstrap filter on a dp = len(devices) mesh against
    the same call at dp = 1 on the first device."""
    from modppl_tpu.models.spiral import spiral_scan_kernel
    from modppl_tpu.parallel.mesh import make_mesh
    from modppl_tpu.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    kernel = spiral_scan_kernel()
    init_c, step_c = _spiral_constraints(num_steps)
    mesh = make_mesh(dp=len(devices), sp=1, devices=devices)

    # the observations go in as arguments: closed over, they become
    # constants that XLA folds differently for each layout, and the
    # final log-weights then differ in the last bit
    def filt(m):
        def run(key, init_c, step_c):
            return sharded_batched_particle_filter(
                m, key, kernel, jnp.zeros(2, jnp.float32), init_c, step_c,
                num_particles, ess_threshold=1.0, auto_batch=True)
        return run

    args = (jax.random.PRNGKey(3), init_c, step_c)
    wide, t_wide = _compile_and_run(filt(mesh), *args)
    one, t_one = _compile_and_run(filt(None), *args)
    timing = {**t_wide, "dp1": t_one}
    return _record(f"sharded_smc_dp{len(devices)}", timing, [
        _check(f"dp{len(devices)} vs dp1 mismatches: {k}",
               _mismatches(wide[k], one[k]), 0, BITWISE_REASON)
        for k in ("log_ml", "ancestors", "state", "log_weights", "ess")])


def phase_pooled_hmc(devices, num_chains=40_000, num_warmup=300,
                     num_samples=500):
    """shardmap_hmc with pooled adaptation on a dp = len(devices) mesh
    against the single-device pooled run."""
    from jax.sharding import Mesh

    from modppl_tpu.parallel.distributed import shardmap_hmc

    model, args, observed, _, _ = _hierarchical_data()
    kwargs = dict(num_samples=num_samples, num_warmup=num_warmup,
                  num_chains=num_chains, num_leapfrog=8)
    key = jax.random.PRNGKey(7)
    runs, timing = {}, {}
    for name, devs in (("wide", devices), ("dp1", devices[:1])):
        t0 = time.perf_counter()
        runs[name] = jax.block_until_ready(shardmap_hmc(
            Mesh(np.array(devs), ("dp",)), key, model, args, observed,
            **kwargs))
        timing[f"{name}_compile_and_run_s"] = time.perf_counter() - t0
    wide, one = runs["wide"], runs["dp1"]
    return _record(f"pooled_hmc_dp{len(devices)}", timing, [
        _check(f"dp{len(devices)} vs dp1 mismatches: {k}",
               _mismatches(wide[k], one[k]), 0, BITWISE_REASON)
        for k in ("step_size", "inv_mass", "unconstrained",
                  "accept_prob")])


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def _card():
    """The cards' name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded paths on four GPUs")
    opts = parser.parse_args(argv)

    from modppl_tpu.utils.compile_cache import configure_compilation_cache

    card = _card()
    print(card)
    print(json.dumps({"jax": jax.__version__, "device_kind": dev.device_kind,
                      "device_count": len(jax.devices()),
                      "compilation_cache": configure_compilation_cache()}))
    if opts.four:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            sys.exit(f"chip_smoke --four: needs 4 GPUs, found "
                     f"{len(devices)}")
        phases = [lambda: phase_sharded_smc(devices),
                  lambda: phase_pooled_hmc(devices)]
    else:
        phases = PHASES
    for phase in phases:
        rec = phase()
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        if not rec["ok"]:
            sys.exit(f"chip_smoke: phase {rec['phase']} failed its checks")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
