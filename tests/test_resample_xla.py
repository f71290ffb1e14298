"""The XLA systematic resampling path against a NumPy reference.

The reference inverts the grid with ``np.searchsorted`` over the sorted
slot positions S (parents[i] = #{j : S_j <= i}); the code under test uses
an integer scatter-add and a cumulative sum. Both start from the same
float32 CDF and uniform, so ancestors must agree exactly, and gathered
rows must be bitwise ``np.take`` of the state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu.parallel.resample import (
    _grid_parents,
    _normalized_cdf,
    systematic_parents,
)
from modppl_tpu.parallel.sharded_smc import _parents_from_s, make_resample_step


def _log_norm(key, n, scale):
    lw = (jax.random.normal(key, (n,)) * scale).astype(jnp.float32)
    return lw - jax.scipy.special.logsumexp(lw)


def _np_parents(cdf, u, n):
    """NumPy grid inverse from the float32 CDF and uniform."""
    cdf = np.asarray(cdf, np.float32)
    s = np.ceil(cdf * np.float32(n) - np.float32(u)).astype(np.int64)
    s = np.maximum.accumulate(np.clip(s, 0, n))
    return np.clip(np.searchsorted(s, np.arange(n), side="right"),
                   0, cdf.shape[0] - 1)


def _np_systematic(key, log_norm):
    n = log_norm.shape[0]
    u = jax.random.uniform(key, (), log_norm.dtype)
    return _np_parents(_normalized_cdf(log_norm), u, n)


@pytest.mark.parametrize("n", [1024, 300 * 1024])
@pytest.mark.parametrize("scale", [0.1, 3.0, 30.0])
def test_systematic_parents_match_numpy(scale, n):
    k_w, k_r = jax.random.split(jax.random.PRNGKey(int(scale * 10) + n))
    lw = _log_norm(k_w, n, scale)
    # eager: the reference's CDF comes from the same eager cumsum (XLA
    # may pick another summation order for a cumsum inside a larger jit)
    got = np.asarray(systematic_parents(k_r, lw))
    np.testing.assert_array_equal(got, _np_systematic(k_r, lw))
    # systematic offspring counts are within one of N times each
    # particle's (float32) CDF increment, up to the float32 rounding of
    # cdf * N (ulp(3e5) ~ 0.03)
    cdf = np.asarray(_normalized_cdf(lw), np.float64)
    counts = np.bincount(got, minlength=n)
    expect = n * np.diff(cdf, prepend=0.0)
    assert np.all(np.abs(counts - expect) <= 1.1)


def test_degenerate_weights_single_ancestor():
    n = 4096
    lw = jnp.full((n,), -jnp.inf, jnp.float32).at[1234].set(0.0)
    parents = np.asarray(systematic_parents(jax.random.PRNGKey(3), lw))
    np.testing.assert_array_equal(parents, np.full(n, 1234))


@pytest.mark.parametrize("width", [2, 7, 8, 12, 16, 31])
def test_resample_step_gathers_rows_bitwise(width):
    n = 4096
    key = jax.random.PRNGKey(width)
    lw = _log_norm(key, n, 0.5)
    state = jax.random.normal(jax.random.fold_in(key, 1), (n, width),
                              jnp.float32) * 3.0
    step = jax.jit(make_resample_step(None, n, 1.0))
    new_state, lw_out, _, parents, ess, do = step(
        jax.random.fold_in(key, 2), lw, state)
    parents = np.asarray(parents)
    assert bool(do)
    np.testing.assert_array_equal(np.asarray(lw_out), np.zeros(n))
    # ancestors are the sorted grid inverse ...
    assert np.all(np.diff(parents) >= 0)
    counts = np.bincount(parents, minlength=n)
    assert np.all(np.abs(counts - n * np.exp(np.asarray(lw, np.float64)))
                  <= 1.0 + 1e-3)
    # ... and the gathered rows are exact copies
    np.testing.assert_array_equal(np.asarray(new_state),
                                  np.take(np.asarray(state), parents, 0))
    w = np.exp(np.asarray(lw, np.float64))
    np.testing.assert_allclose(float(ess), 1.0 / np.sum(w * w), rtol=1e-4)


@pytest.mark.parametrize("scale", [0.1, 3.0, 30.0])
def test_parents_from_s_equals_grid_parents(scale):
    n = 8192
    k_w, k_u = jax.random.split(jax.random.PRNGKey(int(scale * 7)))
    cdf = _normalized_cdf(_log_norm(k_w, n, scale))
    u = jax.random.uniform(k_u, (), cdf.dtype)
    s = jax.lax.cummax(jnp.clip(jnp.ceil(cdf * n - u), 0, n).astype(
        jnp.int32))
    np.testing.assert_array_equal(np.asarray(_parents_from_s(s, n)),
                                  np.asarray(_grid_parents(cdf, u, n)))
    np.testing.assert_array_equal(np.asarray(_parents_from_s(s, n)),
                                  _np_parents(cdf, u, n))
