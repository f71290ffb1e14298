"""Worker process for the multi-process distributed-runtime test.

Launched by tests/test_multiprocess.py as
``python tests/_mp_worker.py <coord_port> <process_id> <num_processes>
<outfile>``. Each process owns 4 virtual CPU devices; together they form
the same 8-device global mesh the single-process suite uses — the CPU
simulation of a 2-host deployment (SURVEY.md:274-276), exercising
jax.distributed.initialize + the cross-process coordinator path of
parallel/mesh.initialize_runtime for real.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hmc_case(mesh):
    """Pooled-adaptation HMC across the mesh: the shardmap_hmc pipeline
    with the global u0s built identically on every process (VERDICT r3 #6
    — the bitwise claim of adaptation.py exercised across processes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.flatten_util import ravel_pytree
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from modppl_tpu import Trie, gen, normal
    from modppl_tpu.inference.hmc import (
        _pooled_chains,
        make_unconstrained_logprob,
    )

    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 1.0), "x")

    obs = Trie.from_dict({"x": 1.0})
    num_chains, num_warmup, num_samples, num_leapfrog = 8, 30, 4, 3
    key = jax.random.PRNGKey(123)
    k_init, k_run = jax.random.split(key)
    init_trace, _ = conjugate.generate(k_init, (), obs)
    logprob, u0, _, _ = make_unconstrained_logprob(
        conjugate, (), init_trace, obs, None)
    u0_flat, unravel = ravel_pytree(u0)

    def logprob_flat(u_flat):
        return logprob(unravel(u_flat))

    chain_keys = jax.random.split(k_run, num_chains)
    jitter = jax.vmap(lambda k: 0.5 * jax.random.normal(
        k, u0_flat.shape, u0_flat.dtype))(chain_keys)
    u0s_np = np.asarray(u0_flat[None, :] + jitter)

    u0s = jax.make_array_from_callback(
        u0s_np.shape, NamedSharding(mesh, P("dp")),
        lambda idx: u0s_np[idx])

    def local_fn(k, u0s_local):
        return _pooled_chains(k, logprob_flat, u0s_local, num_warmup,
                              num_samples, 0.1, num_leapfrog, 0.8,
                              axis_name="dp")

    run = shard_map(local_fn, mesh=mesh,
                    in_specs=(P(), P("dp")),
                    out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P(),
                               P()),
                    check_vma=False)
    us, logps, aprobs, divs, eps, _inv_mass = jax.jit(run)(
        jax.random.fold_in(k_run, 0), u0s)
    return us, aprobs, eps


def _filter_case(mesh, guided):
    """The HEADLINE sharded batched filter across the 2-process mesh
    (VERDICT r4 #4): the halo-ppermute/ring exchange is the repo's most
    collective-dense code and until round 5 its determinism claim stopped
    at single-process. Inputs are built identically on every process;
    returns (state, log_weights, log_ml)."""
    import jax
    import jax.numpy as jnp

    from modppl_tpu import select
    from modppl_tpu.inference.vsmc import ScanKernel
    from modppl_tpu.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    if guided:
        from tests.test_batched_filter import (
            _constraints,
            lg_init,
            lg_optimal_proposal,
            lg_step,
        )

        init_c, step_c = _constraints()
        kernel = ScanKernel(lg_init, lg_step)
        out = sharded_batched_particle_filter(
            mesh, jax.random.PRNGKey(4), kernel, jnp.zeros(()), init_c,
            step_c, 2048, auto_batch=True, proposal=lg_optimal_proposal,
            rejuvenation=(select("x"), 1))
    else:
        from modppl_tpu.models.spiral import spiral_init, spiral_step
        from tests.test_sharded_batched import N, _spiral_inputs

        init_c, step_c = _spiral_inputs()
        kernel = ScanKernel(spiral_init, spiral_step)
        out = sharded_batched_particle_filter(
            mesh, jax.random.PRNGKey(3), kernel,
            jnp.zeros(2, jnp.float32), init_c, step_c, N,
            ess_threshold=1.0, auto_batch=True)
    return out["state"], out["log_weights"], out["log_ml"]


def main():
    port, pid, nprocs, outfile = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "resample"

    import jax

    jax.config.update("jax_enable_x64", True)

    from modppl_tpu.parallel.mesh import global_mesh, initialize_runtime

    initialize_runtime(coordinator_address=f"localhost:{port}",
                       num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from modppl_tpu.parallel.distributed import shardmap_resample_fn

    mesh = global_mesh(sp=1)

    if mode in ("filter", "filter_guided"):
        state, lw, log_ml = _filter_case(mesh, mode == "filter_guided")
        state_full = multihost_utils.process_allgather(state, tiled=True)
        lw_full = multihost_utils.process_allgather(lw, tiled=True)
        if pid == 0:
            np.savez(outfile, state=np.asarray(state_full),
                     log_weights=np.asarray(lw_full),
                     log_ml=np.asarray(log_ml))
        multihost_utils.sync_global_devices("done")
        print(f"worker {pid} OK")
        return

    if mode == "hmc":
        import numpy as np
        from jax.experimental import multihost_utils

        us, aprobs, eps = _hmc_case(mesh)
        us_full = multihost_utils.process_allgather(us, tiled=True)
        ap_full = multihost_utils.process_allgather(aprobs, tiled=True)
        if pid == 0:
            np.savez(outfile, us=np.asarray(us_full),
                     aprobs=np.asarray(ap_full), eps=np.asarray(eps))
        multihost_utils.sync_global_devices("done")
        print(f"worker {pid} OK")
        return

    n = 1024
    # deterministic global inputs, computable identically on every process
    rng = np.random.default_rng(42)
    lw_np = rng.standard_normal(n)
    lw_np = lw_np - np.logaddexp.reduce(lw_np)
    state_np = rng.standard_normal((n, 2))

    sharding = NamedSharding(mesh, P("dp", *([None] * 0)))
    lw = jax.make_array_from_callback(
        (n,), sharding, lambda idx: lw_np[idx])
    state = jax.make_array_from_callback(
        (n, 2), NamedSharding(mesh, P("dp", None)),
        lambda idx: state_np[idx])

    resample = shardmap_resample_fn(mesh)
    key = jax.random.PRNGKey(7)
    new_state, parents, log_total = resample(key, lw, state)

    parents_full = multihost_utils.process_allgather(parents, tiled=True)
    state_full = multihost_utils.process_allgather(new_state, tiled=True)

    if pid == 0:
        np.savez(outfile, parents=np.asarray(parents_full),
                 state=np.asarray(state_full),
                 log_total=np.asarray(log_total))
    multihost_utils.sync_global_devices("done")
    print(f"worker {pid} OK")


if __name__ == "__main__":
    main()
