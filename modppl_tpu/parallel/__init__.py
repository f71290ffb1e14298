"""Mesh parallelism: device meshes, distributed inference, resampling.

SURVEY.md §2b: particle/chain data parallelism over a ``(dp, sp)``
``jax.sharding.Mesh``, collective resampling with a fixed reduction order
(bitwise-deterministic in the shard count), distributed logsumexp, and the
multi-host runtime bring-up wrapper.
"""

from modppl_tpu.parallel.mesh import (
    constrain_particles,
    data_sharding,
    global_mesh,
    initialize_runtime,
    make_mesh,
    particle_sharding,
    replicated,
)
from modppl_tpu.parallel.sharded_smc import (
    make_resample_step,
    sharded_batched_particle_filter,
)
from modppl_tpu.parallel.resample import (
    RESAMPLERS,
    gather_particles,
    multinomial_parents,
    residual_parents,
    stratified_parents,
    systematic_parents,
)

__all__ = [
    "make_mesh", "global_mesh", "initialize_runtime",
    "particle_sharding", "data_sharding", "replicated", "constrain_particles",
    "RESAMPLERS", "systematic_parents", "multinomial_parents",
    "stratified_parents", "residual_parents", "gather_particles",
    "sharded_batched_particle_filter", "make_resample_step",
]
