"""Device-mesh helpers.

Communication backend (SURVEY.md §2b item 4): the reference has zero
cross-process code; here scale-out is ``jax.sharding.Mesh`` +
``pjit``/``shard_map`` with XLA collectives (NCCL over NVLink between the
cards of a host) — no custom transport. Determinism comes from fixed reduction orders (all-gather +
ordered local reduction) and counter-based PRNG keys.

Mesh convention for this framework (a PPL, not an NN trainer):

- ``"dp"`` — particle/chain data-parallel axis (the dominant axis; the PPL
  analog of DP): particles in SMC, chains in MCMC shard here.
- ``"sp"`` — data/likelihood-parallel axis (the PPL analog of SP/TP): plated
  observation vectors shard here, and the per-site logpdf reduction becomes
  a psum inserted by the SPMD partitioner.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_runtime(coordinator_address=None, num_processes=None,
                       process_id=None, **kwargs):
    """Bring up the multi-host JAX distributed runtime (idempotent).

    Thin wrapper over ``jax.distributed.initialize``: pass the
    coordinator address (``host:port``), the process count and this
    process's id in each host process before building a global mesh
    (where a cluster manager exports them, JAX can also detect them).
    Safe to call when already initialized or in single-process runs
    (no-op).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise
    except ValueError:
        # single-process environment with nothing auto-detectable and no
        # explicit coordinator: not a distributed run — proceed locally
        if coordinator_address is not None or num_processes is not None:
            raise


def global_mesh(dp=None, sp=1):
    """(dp, sp) mesh over ALL devices across every participating host
    (``jax.devices()`` is global once the distributed runtime is up)."""
    return make_mesh(dp=dp, sp=sp, devices=jax.devices())


def make_mesh(dp=None, sp=1, devices=None):
    """Build a (dp, sp) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    arr = np.array(devices).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def particle_sharding(mesh):
    """Sharding for per-particle/per-chain arrays: leading axis over dp."""
    return NamedSharding(mesh, P("dp"))


def data_sharding(mesh):
    """Sharding for plated data vectors: leading axis over sp."""
    return NamedSharding(mesh, P("sp"))


def replicated(mesh):
    return NamedSharding(mesh, P())


def constrain_particles(tree, mesh):
    """with_sharding_constraint: leading (particle/chain) axis over dp."""
    if mesh is None:
        return tree
    s = particle_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.lax.with_sharding_constraint(x, s)
        if getattr(x, "ndim", 0) >= 1 else x, tree)
