"""ChEES-HMC (inference/chees.py): the fixed-length alternative
to NUTS (VERDICT r4 #2). Correctness gates: conjugate posterior moments,
trajectory-length adaptation on a correlated target, halton determinism,
and the num_chains guard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu import Trie, gen, normal
from modppl_tpu.dists.iid import iid
from modppl_tpu.inference.chees import chees, chees_runner, halton


def test_halton_low_discrepancy():
    h = halton(64)
    assert h.shape == (64,)
    assert (h > 0).all() and (h < 1).all()
    # radical inverse base 2: first terms 1/2, 1/4, 3/4, 1/8...
    np.testing.assert_allclose(h[:4], [0.5, 0.25, 0.75, 0.125])


def test_chees_conjugate_posterior():
    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 0.5), "x")
        return mu

    obs = Trie.from_dict({"x": 1.0})
    out = chees(jax.random.PRNGKey(0), conjugate, (), obs,
                num_samples=400, num_warmup=300, num_chains=32)
    mus = np.asarray(out["samples"]["mu"])[:, 100:].ravel()
    # posterior: precision 1 + 4 = 5 -> N(0.8, 0.2)
    assert abs(mus.mean() - 0.8) < 0.05, mus.mean()
    assert abs(mus.std() - np.sqrt(0.2)) < 0.05, mus.std()
    assert not np.asarray(out["divergences"]).any()
    # all chains share ONE trajectory length / step count per iteration
    assert np.asarray(out["num_leapfrog"]).shape == (400,)


def test_chees_adapts_trajectory_to_scale():
    """On a long-correlation-length target the adapted trajectory must
    grow well past the initial value (the criterion rewards moving
    across the widest posterior direction)."""
    ys5 = iid(normal, 5)

    @gen
    def wide(h):
        mu = h.sample(normal, (0.0, 10.0), "mu")   # sd-10 latent
        h.sample(ys5, (mu, 8.0), "ys")

    obs = Trie.from_dict({"ys": jnp.zeros(5)})
    out = chees(jax.random.PRNGKey(1), wide, (), obs, num_samples=50,
                num_warmup=300, num_chains=32, step_size=0.5,
                init_traj_length=0.5)
    # posterior sd ~ 3.4; the criterion must GROW the trajectory length
    # far past the (deliberately tiny) 0.5 init. On this 1-D target mass
    # scaling makes near-single-step trajectories optimal, so assert on
    # tau itself, not the leapfrog count.
    assert float(out["trajectory_length"]) > 2.0
    mus = np.asarray(out["samples"]["mu"]).ravel()
    post_prec = 1.0 / 100.0 + 5.0 / 64.0
    assert abs(mus.std() - 1.0 / np.sqrt(post_prec)) < 0.6


def test_chees_requires_multiple_chains():
    @gen
    def m(h):
        h.sample(normal, (0.0, 1.0), "mu")

    with pytest.raises(ValueError, match="num_chains"):
        chees_runner(m, (), Trie(), num_chains=1)


def test_shardmap_chees_matches_single_device():
    """Sharded ChEES (round 5): the dp=8 shard_map run of the identical
    pipeline agrees with the dp=1 run — the pooled (eps, tau, mass) cross
    shards via the fixed add trees; per-chain randoms key off global
    indices."""
    from jax.sharding import Mesh

    from modppl_tpu.parallel.distributed import shardmap_chees

    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 0.5), "x")
        return mu

    obs = Trie.from_dict({"x": 1.0})
    kwargs = dict(num_samples=30, num_warmup=60, num_chains=16,
                  step_size=0.2)
    key = jax.random.PRNGKey(4)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("dp",))
    mesh8 = Mesh(np.array(jax.devices()[:8]), ("dp",))
    one = shardmap_chees(mesh1, key, conjugate, (), obs, **kwargs)
    eight = shardmap_chees(mesh8, key, conjugate, (), obs, **kwargs)
    np.testing.assert_array_equal(np.asarray(one["step_size"]),
                                  np.asarray(eight["step_size"]))
    np.testing.assert_array_equal(
        np.asarray(one["trajectory_length"]),
        np.asarray(eight["trajectory_length"]))
    np.testing.assert_array_equal(np.asarray(one["unconstrained"]),
                                  np.asarray(eight["unconstrained"]))


def test_chees_static_unroll_transition_equivalence():
    """static_unroll (masked static leapfrog loop) must reproduce the
    dynamic fori_loop transition exactly for every step count below the
    cap: same randoms in, same state/logp/accept/proposal out."""
    from modppl_tpu.inference.chees import _chees_transition

    rng = np.random.default_rng(0)
    n, d = 16, 3
    lam = jnp.asarray(np.diag([1.0, 2.0, 0.5]), jnp.float64)

    def logp(u):
        return -0.5 * u @ lam @ u

    vag = jax.vmap(jax.value_and_grad(logp))
    U = jnp.asarray(rng.standard_normal((n, d)))
    LP, G = vag(U)
    im = jnp.asarray([1.0, 0.7, 1.3])
    mom = jnp.asarray(rng.standard_normal((n, d)))
    acc = jnp.asarray(rng.random(n))

    for ns in [1, 5, 12, 16]:
        o_dyn = _chees_transition(vag, U, LP, G, 0.2, jnp.asarray(ns), im,
                                  mom, acc, 1000)
        o_st = _chees_transition(vag, U, LP, G, 0.2, jnp.asarray(ns), im,
                                 mom, acc, 1000, static_unroll=16)
        for a, b in zip(o_dyn, o_st):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-9, atol=1e-9)


def test_chees_static_unroll_conjugate_posterior():
    """The fused static-unroll mode samples the same posterior (and caps
    step counts at static_unroll)."""
    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 0.5), "x")
        return mu

    obs = Trie.from_dict({"x": 1.0})
    out = chees(jax.random.PRNGKey(0), conjugate, (), obs,
                num_samples=400, num_warmup=300, num_chains=32,
                static_unroll=16)
    mus = np.asarray(out["samples"]["mu"])[:, 100:].ravel()
    assert abs(mus.mean() - 0.8) < 0.05, mus.mean()
    assert abs(mus.std() - np.sqrt(0.2)) < 0.05, mus.std()
    assert int(np.asarray(out["num_leapfrog"]).max()) <= 16
