"""Benchmark harness: one JSON line per leg, then a final SUMMARY line
(the SMC headline metric with every leg's value embedded — a reader of
the last line alone still sees every leg).

1. SMC particle-steps/s — the reference's headline SMC demo (spiral
   tracking, modppl/tests/smc.rs:49-92 / dyngenfns/unfold.rs) at 2^20
   particles, run as one compiled XLA program (batched particles x
   lax.scan time, systematic resampling every step).
2. HMC ESS/s (BASELINE.json metric + configs[3]) — 10^4 chains with
   pooled dual-averaging adaptation on the hierarchical model (quadratic
   branch conditioned, so the continuous (a, b, c) posterior is
   exact-tractable); min-coordinate ESS via Geyer's initial monotone
   sequence, divided by total wall time (warmup + sampling).
3. HMC ESS/s at d = 128 on a correlated, ill-conditioned Gaussian target
   (condition number 10^4). Reports MIN-across-coordinates ESS — the
   hardest coordinate bounds the usable sample size — so the pooled
   mass-matrix adaptation is genuinely stressed.
4. NUTS ESS/s on the same hierarchical target (BASELINE configs[3]
   "NUTS/HMC"): the vmapped while_loop batch-max cost in the realistic
   multi-chain setting.

Further legs: guided+rejuvenated SMC at N = 2^20, non-quadratic HMC at
10^4 chains (Bayesian logistic regression d=16), ChEES-HMC at 10^4 chains
head-to-head with the NUTS leg, and mean-field ADVI MC-evals/s on the
logistic regression.

vs_baseline for every line is measured against a 1e6/s scale (the
reference publishes no throughput numbers at all; BASELINE.md rows are
correctness tolerances).

Needs a GPU and exits without one: a number taken on another backend is
not this system's number. x64 stays OFF here — float32 is the compute
dtype; correctness at float64 is covered by the test suite. Runs every
leg in this one process. Usage: ``python bench.py``.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

# every leg's result dict, in emission order — main() prints a final
# SUMMARY line (the SMC headline metric + a compact map of every leg's
# value) so a tail-truncated capture of stdout still carries all legs
_RESULTS = []


def _emit(d):
    _RESULTS.append(d)
    print(json.dumps(d))
    sys.stdout.flush()


def bench_hmc():
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.inference.hmc import hmc_runner
    from modppl_tpu.models.hierarchical_static import (
        NOISE,
        make_hierarchical_static,
    )
    from modppl_tpu.utils.diagnostics import ess_autocorr

    n_points = 10
    xs = jnp.linspace(-1.0, 1.0, n_points)
    ys = jnp.asarray(0.3 + 0.5 * xs - 0.8 * xs * xs
                     + NOISE * np.random.default_rng(0).standard_normal(
                         n_points), jnp.float32)
    model = make_hierarchical_static(n_points)
    observed = Trie.from_dict({"ys": ys, "is_linear": False})

    num_chains = 10_000
    num_warmup, num_samples = 300, 500

    # compiled-runner API: setup + trace once, then each call is one
    # cached XLA program — steady-state production throughput
    run = hmc_runner(model, (xs,), observed, num_samples=num_samples,
                     num_warmup=num_warmup, num_chains=num_chains,
                     num_leapfrog=8, setup_key=jax.random.PRNGKey(99))
    out = run(jax.random.PRNGKey(0))  # compile + warmup
    jax.block_until_ready(out["unconstrained"])
    # async-dispatch 3 runs, one sync: steady-state throughput
    reps = 3
    t0 = time.perf_counter()
    outs = [run(jax.random.PRNGKey(i + 1)) for i in range(reps)]
    jax.block_until_ready(outs)
    wall = (time.perf_counter() - t0) / reps
    out = outs[-1]

    # min-across-coordinates ESS (round 5 — legs 3-4 adopted it in round
    # 4; the headline leg now matches: the hardest coordinate bounds the
    # usable sample size)
    us = np.asarray(out["unconstrained"])  # (chains, draws, 3)
    ess_per_coord = np.array(
        [ess_autocorr(us[:, :, j]) for j in range(us.shape[-1])])
    ess = float(ess_per_coord.min())
    ess_per_s = ess / wall

    _emit(({
        "metric": "hmc_ess_per_s_1chip",
        "value": round(ess_per_s, 1),
        "unit": "min-coord ESS/s",
        "vs_baseline": round(ess_per_s / 1e6, 3),
        "chains": num_chains,
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "ess_min": round(ess, 1),
        "ess_median": round(float(np.median(ess_per_coord)), 1),
        "accept_rate": round(float(jnp.mean(out["accept_prob"])), 3),
        "seconds": round(wall, 4),
        "platform": jax.devices()[0].platform,
    }))


def bench_hmc_nonquad():
    """HMC leg 2b: a NON-quadratic target — Bayesian logistic regression
    (models/logreg.py), the reference's arbitrary-differentiable-model
    class (gfi.rs:49-92) — through the generic pooled path at 10^4 chains
    (pre-drawn randoms, (u, logp, grad) carry, unrolled value_and_grad
    leapfrog, fused pooled stats)."""
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.inference.hmc import hmc_runner
    from modppl_tpu.models.logreg import make_logreg, simulate_logreg
    from modppl_tpu.utils.diagnostics import ess_autocorr

    # (d, n_data, L) = (16, 128, 4): a short trajectory on a small data
    # term; R4 in ROADMAP.md asks for deployment-size data
    d, n_data = 16, 128
    X, ys, _ = simulate_logreg(jax.random.PRNGKey(42), n_data, d)
    model = make_logreg(d)
    num_chains, num_warmup, num_samples = 10_000, 300, 500

    run = hmc_runner(model, (X, ys), Trie(), num_samples=num_samples,
                     num_warmup=num_warmup, num_chains=num_chains,
                     num_leapfrog=4, setup_key=jax.random.PRNGKey(99))
    out = run(jax.random.PRNGKey(0))
    jax.block_until_ready(out["unconstrained"])
    reps = 3
    t0 = time.perf_counter()
    outs = [run(jax.random.PRNGKey(i + 1)) for i in range(reps)]
    jax.block_until_ready(outs)
    wall = (time.perf_counter() - t0) / reps
    out = outs[-1]

    us = np.asarray(out["unconstrained"])  # (chains, draws, d)
    ess_per_coord = np.array(
        [ess_autocorr(us[:, :, j]) for j in range(d)])
    ess_min = float(ess_per_coord.min())
    ess_per_s = ess_min / wall

    _emit(({
        "metric": "hmc_nonquad_ess_per_s_1chip",
        "value": round(ess_per_s, 1),
        "unit": "min-coord ESS/s",
        "vs_baseline": round(ess_per_s / 1e6, 3),
        "chains": num_chains,
        "dim": d,
        "n_data": n_data,
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "ess_min": round(ess_min, 1),
        "ess_median": round(float(np.median(ess_per_coord)), 1),
        "accept_rate": round(float(jnp.mean(out["accept_prob"])), 3),
        "seconds": round(wall, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()


def bench_hmc_d128():
    """HMC leg 3: d=128 correlated ill-conditioned Gaussian, min-coord ESS.

    Runs the generic pooled path. ESS is the MINIMUM across all 128
    coordinates (the hardest direction bounds the usable sample size)."""
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.inference.hmc import hmc_runner
    from modppl_tpu.models.illcond_gauss import make_illcond_gauss
    from modppl_tpu.utils.diagnostics import ess_autocorr

    d, cond = 128, 1e4
    model = make_illcond_gauss(d, cond)
    num_chains, num_warmup, num_samples = 4096, 300, 256

    run = hmc_runner(model, (), Trie(), num_samples=num_samples,
                     num_warmup=num_warmup, num_chains=num_chains,
                     num_leapfrog=32, setup_key=jax.random.PRNGKey(99))
    out = run(jax.random.PRNGKey(0))
    jax.block_until_ready(out["unconstrained"])
    reps = 3
    t0 = time.perf_counter()
    outs = [run(jax.random.PRNGKey(i + 1)) for i in range(reps)]
    jax.block_until_ready(outs)
    wall = (time.perf_counter() - t0) / reps
    out = outs[-1]

    us = np.asarray(out["unconstrained"])  # (chains, draws, d)
    ess_per_coord = np.array(
        [ess_autocorr(us[:, :, j]) for j in range(d)])
    ess_min = float(ess_per_coord.min())
    ess_per_s = ess_min / wall

    _emit(({
        "metric": "hmc_ess_per_s_d128_illcond_1chip",
        "value": round(ess_per_s, 1),
        "unit": "min-coord ESS/s",
        "vs_baseline": round(ess_per_s / 1e6, 4),
        "chains": num_chains,
        "dim": d,
        "condition_number": cond,
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "ess_min": round(ess_min, 1),
        "ess_median": round(float(np.median(ess_per_coord)), 1),
        "accept_rate": round(float(jnp.mean(out["accept_prob"])), 3),
        "seconds": round(wall, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()


def bench_nuts():
    """NUTS leg (BASELINE configs[3]): pooled-adaptation NUTS on the
    hierarchical target; measures the vmapped while_loop batch-max cost in
    the realistic multi-chain setting."""
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.inference.nuts import nuts_runner
    from modppl_tpu.models.hierarchical_static import (
        NOISE,
        make_hierarchical_static,
    )
    from modppl_tpu.utils.diagnostics import ess_autocorr

    n_points = 10
    xs = jnp.linspace(-1.0, 1.0, n_points)
    ys = jnp.asarray(0.3 + 0.5 * xs - 0.8 * xs * xs
                     + NOISE * np.random.default_rng(0).standard_normal(
                         n_points), jnp.float32)
    model = make_hierarchical_static(n_points)
    observed = Trie.from_dict({"ys": ys, "is_linear": False})

    # 10^4 chains (round 5; was 2048) — the north-star scale, so the
    # ChEES leg below is an honest head-to-head
    num_chains, num_warmup, num_samples = 10_000, 200, 300
    run = nuts_runner(model, (xs,), observed, num_samples=num_samples,
                      num_warmup=num_warmup, num_chains=num_chains,
                      max_depth=6, setup_key=jax.random.PRNGKey(99))
    out = run(jax.random.PRNGKey(0))
    jax.block_until_ready(out["unconstrained"])
    reps = 3
    t0 = time.perf_counter()
    outs = [run(jax.random.PRNGKey(i + 1)) for i in range(reps)]
    jax.block_until_ready(outs)
    wall = (time.perf_counter() - t0) / reps
    out = outs[-1]

    us = np.asarray(out["unconstrained"])  # (chains, draws, 3)
    ess_per_coord = np.array(
        [ess_autocorr(us[:, :, j]) for j in range(us.shape[-1])])
    ess_min = float(ess_per_coord.min())
    ess_per_s = ess_min / wall

    _emit(({
        "metric": "nuts_ess_per_s_1chip",
        "value": round(ess_per_s, 1),
        "unit": "min-coord ESS/s",
        "vs_baseline": round(ess_per_s / 1e6, 3),
        "chains": num_chains,
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "ess_min": round(ess_min, 1),
        "mean_tree_depth": round(float(jnp.mean(out["tree_depth"])), 2),
        "accept_rate": round(float(jnp.mean(out["accept_prob"])), 3),
        "seconds": round(wall, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()


def bench_chees():
    """ChEES-HMC leg: the fixed-length alternative to NUTS on the SAME hierarchical target, same chain count,
    same warmup/sample budget — pooled trajectory-length adaptation gives
    every chain ONE shared leapfrog count per iteration (uniform control
    flow), where NUTS pays the vmapped while_loop batch-max tree depth."""
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.inference.chees import chees_runner
    from modppl_tpu.models.hierarchical_static import (
        NOISE,
        make_hierarchical_static,
    )
    from modppl_tpu.utils.diagnostics import ess_autocorr

    n_points = 10
    xs = jnp.linspace(-1.0, 1.0, n_points)
    ys = jnp.asarray(0.3 + 0.5 * xs - 0.8 * xs * xs
                     + NOISE * np.random.default_rng(0).standard_normal(
                         n_points), jnp.float32)
    model = make_hierarchical_static(n_points)
    observed = Trie.from_dict({"ys": ys, "is_linear": False})

    num_chains, num_warmup, num_samples = 10_000, 200, 300
    run = chees_runner(model, (xs,), observed, num_samples=num_samples,
                       num_warmup=num_warmup, num_chains=num_chains,
                       setup_key=jax.random.PRNGKey(99))
    out = run(jax.random.PRNGKey(0))
    jax.block_until_ready(out["unconstrained"])
    reps = 3
    t0 = time.perf_counter()
    outs = [run(jax.random.PRNGKey(i + 1)) for i in range(reps)]
    jax.block_until_ready(outs)
    wall = (time.perf_counter() - t0) / reps
    out = outs[-1]

    us = np.asarray(out["unconstrained"])  # (chains, draws, 3)
    ess_per_coord = np.array(
        [ess_autocorr(us[:, :, j]) for j in range(us.shape[-1])])
    ess_min = float(ess_per_coord.min())
    ess_per_s = ess_min / wall

    _emit(({
        "metric": "chees_ess_per_s_1chip",
        "value": round(ess_per_s, 1),
        "unit": "min-coord ESS/s",
        "vs_baseline": round(ess_per_s / 1e6, 3),
        "chains": num_chains,
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "ess_min": round(ess_min, 1),
        "trajectory_length": round(float(out["trajectory_length"]), 3),
        "mean_leapfrog": round(float(np.mean(
            np.asarray(out["num_leapfrog"]))), 2),
        "accept_rate": round(float(jnp.mean(out["accept_prob"])), 3),
        "seconds": round(wall, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()


def bench_vi():
    """VI leg: mean-field ADVI on the d=16 logistic regression at 1024 MC
    samples per step (the per-step work is a (num_mc, d) x (d, n_data)
    matmul pair in the forward and reverse passes). Metric: ELBO
    Monte-Carlo model evaluations per second (num_steps x num_mc / wall);
    posterior-moment correctness for this family is gated in
    tests/test_hmc_vi.py and tests/test_vi_minibatch.py."""
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.inference.vi import advi
    from modppl_tpu.models.logreg import make_logreg, simulate_logreg

    d, n_data, num_mc, num_steps = 16, 256, 1024, 2000
    X, ys, _ = simulate_logreg(jax.random.PRNGKey(7), n_data, d)
    model = make_logreg(d)

    def run(seed):
        return advi(jax.random.PRNGKey(seed), model, (X, ys), Trie(),
                    num_steps=num_steps, num_mc=num_mc,
                    learning_rate=5e-3)

    out = run(0)
    jax.block_until_ready(out["elbo"])
    reps = 3
    t0 = time.perf_counter()
    outs = [run(i + 1) for i in range(reps)]
    jax.block_until_ready([o["elbo"] for o in outs])
    wall = (time.perf_counter() - t0) / reps
    out = outs[-1]

    mc_per_s = num_steps * num_mc / wall
    _emit(({
        "metric": "vi_elbo_mc_evals_per_s_1chip",
        "value": round(mc_per_s, 1),
        "unit": "MC model evals/s",
        "vs_baseline": round(mc_per_s / 1e6, 3),
        "dim": d,
        "n_data": n_data,
        "num_mc": num_mc,
        "num_steps": num_steps,
        "final_elbo": round(float(np.mean(np.asarray(out["elbo"])[-50:])),
                            2),
        "seconds": round(wall, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()


_LG_CACHE = {}


def _lg_kernels():
    """Scalar linear-Gaussian kernel + locally-optimal proposal for the
    guided bench leg (module-level cache: Gen objects are static jit args,
    so one identity per process keeps the jit cache warm)."""
    if _LG_CACHE:
        return _LG_CACHE["k"]
    import jax.numpy as jnp

    from modppl_tpu import gen, normal

    A, Q, R = 0.9, 0.5, 0.3

    @gen
    def lg_init(h, _s0):
        x = h.sample(normal, (0.0, 1.0), "x")
        h.sample(normal, (x, R), "y")
        return x

    @gen
    def lg_step(h, t, prev):
        x = h.sample(normal, (A * prev, Q), "x")
        h.sample(normal, (x, R), "y")
        return x

    @gen
    def lg_prop(h, t, prev, cons):
        # p(x_t | x_{t-1}, y_t) in closed form: zero-variance increments
        y = cons.read("y")
        prec = 1.0 / Q**2 + 1.0 / R**2
        m = (A * prev / Q**2 + y / R**2) / prec
        h.sample(normal, (m, 1.0 / jnp.sqrt(prec)), "x")

    _LG_CACHE["k"] = (lg_init, lg_step, lg_prop, A, Q, R)
    return _LG_CACHE["k"]


def bench_smc_guided():
    """Guided + rejuvenated SMC leg: proposal + resample-move on the
    sharded batched tier. Same N = 2^20 / T = 10 scale
    as the headline bootstrap leg, on a scalar linear-Gaussian SSM with
    the locally-optimal proposal and one regenerative move per step —
    regressions in the propose/merge/constrained-generate/moves path now
    show up here."""
    import numpy as np

    from modppl_tpu import Trie, select
    from modppl_tpu.inference.vsmc import ScanKernel
    from modppl_tpu.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    lg_init, lg_step, lg_prop, A, Q, R = _lg_kernels()
    num_particles = 1 << 20
    num_steps = 10
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal()]
    for _ in range(num_steps - 1):
        xs.append(A * xs[-1] + Q * rng.standard_normal())
    obs = [jnp.asarray(x + R * rng.standard_normal(), jnp.float32)
           for x in xs]
    init_c = Trie.from_dict({"y": obs[0]})
    step_c = jax.tree_util.tree_map(
        lambda *v: jnp.stack(v),
        *[Trie.from_dict({"y": o}) for o in obs[1:]])
    kernel = ScanKernel(lg_init, lg_step)

    def run(seed):
        out = sharded_batched_particle_filter(
            None, jax.random.PRNGKey(seed), kernel, jnp.zeros(()),
            init_c, step_c, num_particles, ess_threshold=1.0,
            auto_batch=True, store_ancestry=False, proposal=lg_prop,
            rejuvenation=(select("x"), 1))
        return out["log_ml"]

    jax.block_until_ready(run(0))
    reps = 8
    times = []
    for r in range(2):
        t0 = time.perf_counter()
        outs = [run(10 * r + i + 1) for i in range(reps)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / reps)
    best = min(times)
    pps = num_particles * num_steps / best

    _emit(({
        "metric": "smc_guided_rejuv_particle_steps_per_s_1chip",
        "value": round(pps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(pps / 1e6, 3),
        "particles": num_particles,
        "steps": num_steps,
        "proposal": "locally_optimal",
        "rejuvenation_moves": 1,
        "seconds_per_filter": round(best, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform!r}")
    import numpy as np

    from modppl_tpu import Trie
    from modppl_tpu.utils.compile_cache import configure_compilation_cache
    from modppl_tpu.models.spiral import spiral_scan_kernel
    from modppl_tpu.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    configure_compilation_cache()
    # 2^20 particles (>= the 10^6 north star)
    num_particles = 1 << 20
    num_steps = 10  # T: 1 init + 9 scan steps

    kernel = spiral_scan_kernel()

    # observations on a circle, matching the demo's geometry
    obs = []
    for t in range(num_steps):
        ang = 2 * np.pi * t / 16.0
        obs.append(jnp.array([0.4 * np.cos(ang), 0.4 * np.sin(ang)],
                             dtype=jnp.float32))
    init_c = Trie.from_dict({"obs": obs[0]})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[Trie.from_dict({"obs": o}) for o in obs[1:]])

    def run(seed):
        # the UNIFIED path (VERDICT r3 #1): the same sharded_batched_
        # particle_filter that scales over a dp mesh, here at dp=1 — the
        # headline number and the multi-chip path are one code path.
        # store_ancestry=False drops the (T, N) ancestry stack (only
        # log-ML is consumed, matching vsmc's store_traces convention).
        out = sharded_batched_particle_filter(
            None, jax.random.PRNGKey(seed), kernel,
            jnp.zeros(2, jnp.float32), init_c, step_c, num_particles,
            ess_threshold=1.0, auto_batch=True, store_ancestry=False)
        return out["log_ml"]

    # compile + warmup, then timed: two rounds of 12 filters dispatched
    # ASYNC then synced once — steady-state throughput
    jax.block_until_ready(run(0))
    reps = 12
    times = []
    for r in range(2):
        t0 = time.perf_counter()
        outs = [run(10 * r + i + 1) for i in range(reps)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / reps)
    best = min(times)
    particle_steps_per_s = num_particles * num_steps / best

    _emit(({
        "metric": "smc_particle_steps_per_s_1chip",
        "value": round(particle_steps_per_s, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(particle_steps_per_s / 1e6, 3),
        "particles": num_particles,
        "steps": num_steps,
        "seconds_per_filter": round(best, 4),
        "platform": jax.devices()[0].platform,
    }))
    sys.stdout.flush()
    bench_smc_guided()
    bench_hmc()
    bench_hmc_nonquad()
    bench_hmc_d128()
    bench_nuts()
    bench_chees()
    bench_vi()

    # FINAL line = the headline metric again, with every leg's value
    # embedded, so a reader of the last line alone sees every leg
    head = next(r for r in _RESULTS
                if r["metric"] == "smc_particle_steps_per_s_1chip")
    summary = {k: head[k] for k in
               ("metric", "value", "unit", "vs_baseline", "platform")}
    summary["legs"] = {r["metric"]: [r["value"], r["unit"]]
                       for r in _RESULTS}
    print(json.dumps(summary))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
