"""Sharded batched-tier SMC (parallel/sharded_smc.py) — VERDICT r3 #1.

Asserts the three "done" criteria:
1. bitwise equality of the batched tier across layouts (dp=1 vs dp=2 vs
   dp=8) — states, log-weights, ancestors and log-ML;
2. the compiled dp=8 program contains NO full-(N, C) all-gather of particle
   state (only the O(N) int32 ancestor-position gather and O(N) f32 weight
   partials are allowed);
3. the ring fallback (degenerate weight concentration escaping the halo
   window) produces the same rows as the layout-invariant reference.

Also checks the sharded filter against the exact Kalman log-ML oracle so
the collective path is quantitatively correct, not just self-consistent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu import Trie
from modppl_tpu.inference.vsmc import ScanKernel
from modppl_tpu.models.spiral import spiral_init, spiral_step
from modppl_tpu.parallel.mesh import make_mesh
from modppl_tpu.parallel.sharded_smc import (
    make_resample_step,
    sharded_batched_particle_filter,
)

from tests.test_batched_filter import (
    kalman_log_ml,
    lg_init_batched,
    lg_step_batched,
)

N = 1024
T = 6


def _spiral_inputs(seed=0):
    rng = np.random.default_rng(seed)
    obs = [jnp.asarray(0.4 * np.array([np.cos(a), np.sin(a)])
                       + 0.01 * rng.standard_normal(2), jnp.float32)
           for a in np.linspace(0.0, 2.0, T)]
    init_c = Trie.from_dict({"obs": obs[0]})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[Trie.from_dict({"obs": o}) for o in obs[1:]])
    return init_c, step_c


def _run(mesh, ess_threshold=1.0, halo=None, seed=3):
    init_c, step_c = _spiral_inputs()
    kernel = ScanKernel(spiral_init, spiral_step)
    return sharded_batched_particle_filter(
        mesh, jax.random.PRNGKey(seed), kernel, jnp.zeros(2, jnp.float32),
        init_c, step_c, N, ess_threshold=ess_threshold, auto_batch=True,
        halo=halo)


def _assert_bitwise_equal(a, b):
    for k in ("log_ml", "log_weights", "state", "ancestors", "ess"):
        np.testing.assert_array_equal(
            np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_layout_invariance_dp1_dp2_dp8():
    out1 = _run(None)
    out2 = _run(make_mesh(dp=2, sp=1, devices=jax.devices()[:2]))
    out8 = _run(make_mesh(sp=1))
    _assert_bitwise_equal(out1, out8)
    _assert_bitwise_equal(out2, out8)


def test_layout_invariance_with_ess_threshold():
    # partial-resampling path: the cond predicate must agree across layouts
    out1 = _run(None, ess_threshold=0.1)
    out8 = _run(make_mesh(sp=1), ess_threshold=0.1)
    assert bool(np.asarray(out8["resampled"]).any())
    assert not bool(np.asarray(out8["resampled"]).all())
    _assert_bitwise_equal(out1, out8)


def test_layout_invariance_tiny_halo_forces_ring():
    # halo=1: essentially every resample misses the window -> ring fallback
    out1 = _run(None)
    out8 = _run(make_mesh(sp=1), halo=1)
    _assert_bitwise_equal(out1, out8)


def test_no_state_allgather_in_hlo():
    mesh = make_mesh(sp=1)
    init_c, step_c = _spiral_inputs()
    kernel = ScanKernel(spiral_init, spiral_step)

    import modppl_tpu.parallel.sharded_smc as mod

    traced = jax.jit(
        lambda k: mod.sharded_batched_particle_filter(
            mesh, k, kernel, jnp.zeros(2, jnp.float32), init_c, step_c, N,
            auto_batch=True))
    txt = traced.lower(jax.random.PRNGKey(0)).compile().as_text()
    import re

    # every all-gather result must stay at or below the O(N) ancestor /
    # weight vectors: 4 bytes x N (s32[N] or f32[N]); a full state gather
    # would be f32[N, C>=2] = 8N+ bytes
    budget = 4 * N + 4096
    for m in re.finditer(r"all-gather[^=]*=?\s*[a-z0-9]+\[([0-9,]*)\]", txt):
        dims = [int(d) for d in m.group(1).split(",") if d]
        size = 4
        for d in dims:
            size *= d
        assert size <= budget, f"oversized all-gather: {m.group(0)}"
    assert "all-gather" in txt  # the ancestor gather must be there


def test_resample_step_degenerate_weights_ring_path():
    """All mass on one particle: every shard's parents escape any halo —
    the ring fallback must still produce the layout-invariant rows."""
    mesh = make_mesh(sp=1)
    lw = jnp.full((N,), -1e30, jnp.float32).at[N - 3].set(0.0)
    state = jnp.stack([jnp.arange(N, dtype=jnp.float32),
                       jnp.arange(N, dtype=jnp.float32) * 2.0], axis=1)

    step1 = make_resample_step(None, N, 1.0)
    step8 = make_resample_step(mesh, N, 1.0, halo=4)
    key = jax.random.PRNGKey(0)
    s1, lw1, dml1, par1, ess1, do1 = jax.jit(step1)(key, lw, state)
    s8, lw8, dml8, par8, ess8, do8 = jax.jit(step8)(key, lw, state)
    np.testing.assert_array_equal(np.asarray(par1), np.asarray(par8))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s8))
    np.testing.assert_array_equal(np.asarray(dml1), np.asarray(dml8))
    assert bool(do8)
    # and the rows really are the heavy particle's
    assert np.all(np.asarray(par8) == N - 3)
    np.testing.assert_array_equal(
        np.asarray(s8), np.broadcast_to(np.asarray(state[N - 3]), (N, 2)))


def test_sharded_kalman_log_ml_oracle():
    """Quantitative gate: sharded batched filter vs the exact Kalman
    marginal likelihood (the reference's particle_filter.rs:76 style gate,
    0.03 tolerance at modest N)."""
    rng = np.random.default_rng(7)
    T_k = 10
    xs = [rng.standard_normal() * 1.0]
    for _ in range(T_k - 1):
        xs.append(0.9 * xs[-1] + 0.5 * rng.standard_normal())
    ys = np.asarray([x + 0.3 * rng.standard_normal() for x in xs],
                    dtype=np.float32)

    init_c = Trie.from_dict({"y": jnp.asarray(ys[0])})
    step_c = jax.tree_util.tree_map(
        lambda *vs: jnp.stack(vs),
        *[Trie.from_dict({"y": jnp.asarray(y)}) for y in ys[1:]])

    kernel = ScanKernel(lg_init_batched, lg_step_batched)
    mesh = make_mesh(sp=1)
    out = sharded_batched_particle_filter(
        mesh, jax.random.PRNGKey(11), kernel, jnp.zeros((), jnp.float32),
        init_c, step_c, 4096)
    exact = kalman_log_ml(ys)
    assert abs(float(out["log_ml"]) - exact) < 0.05, (
        float(out["log_ml"]), exact)


def test_sharded_guided_rejuvenated_layout_invariance():
    """Guided + resample-move on the SHARDED filter: bitwise-identical
    dp=1 vs dp=8, and the Kalman log-ML gate still holds (the full
    algorithm set of the batched tier runs under the mesh)."""
    from modppl_tpu import select

    from tests.test_batched_filter import (
        YS,
        _constraints,
        kalman_log_ml,
        lg_init,
        lg_optimal_proposal,
        lg_step,
    )

    init_c, step_c = _constraints()
    kernel = ScanKernel(lg_init, lg_step)

    def run(mesh):
        return sharded_batched_particle_filter(
            mesh, jax.random.PRNGKey(4), kernel, jnp.zeros(()), init_c,
            step_c, 2048, auto_batch=True, proposal=lg_optimal_proposal,
            rejuvenation=(select("x"), 1))

    out1 = run(None)
    out8 = run(make_mesh(sp=1))
    _assert_bitwise_equal(out1, out8)
    assert abs(float(out8["log_ml"]) - kalman_log_ml(YS)) < 0.1
