"""GFI semantic-contract regression tests.

Port of modppl/tests/dyngenfn.rs — the exact update/regenerate weight values
in each (prev?, constrained?) case, discard/visitor-GC semantics on branch
switches, and residual-constraint errors. These constants are the contract
this build must reproduce bit-for-bit (SURVEY.md §4).
"""

import math

import jax
import jax.numpy as jnp
import pytest

from modppl_tpu import (
    ArgDiff, Trie, bernoulli, gen, normal, poisson, select, uniform,
)


def key(i=0):
    return jax.random.PRNGKey(i)


# --- models (dyngenfn.rs:32-55) ---------------------------------------------

@gen
def branch_normal(h):
    b = h.sample(bernoulli, 0.25, "b")
    if b:
        h.sample(normal, (0.0, 1.0), "x")


@gen
def sub_normal(h, noise):
    return h.sample(normal, (1.0, noise), "s")


@gen
def branch_traced(h):
    b = h.sample(bernoulli, 0.25, "b")
    if b:
        h.trace(sub_normal, (1.0,), "sub")


@gen
def m_model(h):
    m = h.sample(uniform, (0.0, 1.0), "m")
    h.sample(normal, (m, 1.0), "x")
    h.sample(normal, (m, 1.0), "y")


def trie_of(**kwargs):
    t = Trie()
    for k, v in kwargs.items():
        t.observe(k, v)
    return t


# --- update weight regressions (dyngenfn.rs:57-114) -------------------------

def test_sample_at_update_prev_and_constrained():
    tr, _ = branch_normal.generate(key(), (), trie_of(b=True, x=0.0))
    _, _, w = branch_normal.update(key(1), tr, (), ArgDiff.UNKNOWN, trie_of(x=1.0))
    assert float(w) == pytest.approx(-0.5)  # dyngenfn.rs:65


def test_sample_at_update_no_prev_and_constrained():
    tr, _ = branch_normal.generate(key(), (), trie_of(b=False))
    _, _, w = branch_normal.update(
        key(1), tr, (), ArgDiff.UNKNOWN, trie_of(b=True, x=1.0))
    assert float(w) == pytest.approx(-2.517551, abs=1e-6)  # dyngenfn.rs:78


def test_update_sample_at_prev_and_unconstrained():
    tr, _ = m_model.generate(key(), (), trie_of(m=1.0, x=1.0, y=-0.3))
    _, _, w = m_model.update(key(1), tr, (), ArgDiff.UNKNOWN, trie_of(m=0.5))
    assert float(w) == pytest.approx(0.4, abs=1e-6)  # dyngenfn.rs:92


def test_update_no_prev_and_unconstrained():
    # sample_at (dyngenfn.rs:96-104)
    tr, _ = branch_normal.generate(key(), (), trie_of(b=False))
    _, _, w = branch_normal.update(key(1), tr, (), ArgDiff.UNKNOWN, trie_of(b=True))
    assert float(w) == pytest.approx(-1.098612, abs=1e-6)

    # trace_at (dyngenfn.rs:106-113)
    tr, _ = branch_traced.generate(key(), (), trie_of(b=False))
    _, _, w = branch_traced.update(key(1), tr, (), ArgDiff.UNKNOWN, trie_of(b=True))
    assert float(w) == pytest.approx(-1.098612, abs=1e-6)


def test_generate_residual_constraints_raises():
    with pytest.raises(ValueError):
        m_model.generate(key(), (), trie_of(abc=0.0))


def test_update_residual_constraints_raises():
    tr = m_model.simulate(key(), ())
    with pytest.raises(ValueError):
        m_model.update(key(1), tr, (), ArgDiff.NO_CHANGE, trie_of(abc=0.0))


# --- simulate (dyngenfn.rs:167-178) -----------------------------------------

def test_simulate():
    @gen
    def foo(h, p):
        return h.sample(bernoulli, p, "x")

    p = 0.4
    trace = foo.simulate(key(7), (p,))
    assert bool(trace.data.read("x")) == bool(trace.retv)
    assert trace.args == (p,)
    expected = math.log(p) if bool(trace.data.read("x")) else math.log(1 - p)
    assert float(trace.logjp) == pytest.approx(expected)


# --- update with branch switch + GC (dyngenfn.rs:181-245) -------------------

@gen
def bar(h):
    return h.sample(normal, (0.0, 1.0), "a")


@gen
def baz(h):
    return h.sample(normal, (0.0, 1.0), "b")


@gen
def foo_branch(h):
    if h.sample(bernoulli, 0.4, "branch"):
        h.sample(normal, (0.0, 1.0), "x")
        return h.trace(bar, (), "u")
    else:
        h.sample(normal, (0.0, 1.0), "y")
        return h.trace(baz, (), "v")


def test_update_branch_switch():
    trace, _ = foo_branch.generate(key(3), (), trie_of(branch=True))
    x = trace.data.read("x")
    a = trace.data.read("u/a")

    y, b = 1.123, -2.1
    constraints = Trie()
    constraints.observe("branch", False)
    constraints.observe("y", y)
    constraints.observe("v/b", b)
    new_trace, discard, weight = foo_branch.update(
        key(4), trace, (), ArgDiff.NO_CHANGE, constraints)

    # discard contents (dyngenfn.rs:209-214)
    assert bool(discard.read("branch")) is True
    assert float(discard.read("x")) == float(x)
    assert float(discard.read("u/a")) == float(a)
    leaves = sum(1 for _, s in discard if s.is_leaf())
    non_leaves = sum(1 for _, s in discard if not s.is_leaf())
    assert (leaves, non_leaves) == (2, 1)

    # new trace contents (dyngenfn.rs:216-222)
    data = new_trace.data
    assert bool(data.read("branch")) is False
    assert float(data.read("y")) == y
    assert float(data.read("v/b")) == b
    leaves = sum(1 for _, s in data if s.is_leaf())
    non_leaves = sum(1 for _, s in data if not s.is_leaf())
    assert (leaves, non_leaves) == (2, 1)

    # logjp and weight (dyngenfn.rs:224-235)
    def nlp(v, mu, std):
        return float(normal.logpdf(v, (mu, std)))

    prev_logjp = float(bernoulli.logpdf(True, 0.4)) + nlp(x, 0, 1) + nlp(a, 0, 1)
    expected_new_logjp = float(bernoulli.logpdf(False, 0.4)) + nlp(y, 0, 1) + nlp(b, 0, 1)
    assert float(new_trace.logjp) == pytest.approx(expected_new_logjp, abs=1e-3)
    assert float(weight) == pytest.approx(expected_new_logjp - prev_logjp, abs=1e-3)


def test_update_visited_namespace_not_discarded():
    # dyngenfn.rs:237-268: addresses under "data" are visited; nothing there
    # is discarded when only "a" changes.
    @gen
    def loopy(h):
        a = h.sample(normal, (0.0, 1.0), "a")
        for i in range(5):
            h.sample(normal, (a, 1.0), f"data/{i}")

    constraints = trie_of(a=0.0)
    for i in range(5):
        constraints.observe(f"data/{i}", 0.0)
    trace, _ = loopy.generate(key(5), (), constraints)

    new_trace, discard, weight = loopy.update(
        key(6), trace, (), ArgDiff.NO_CHANGE, trie_of(a=1.0))
    assert float(discard.read("a")) == 0.0
    prev_logjp = 6.0 * float(normal.logpdf(0.0, (0.0, 1.0)))
    expected_new_logjp = float(normal.logpdf(1.0, (0.0, 1.0))) + \
        5.0 * float(normal.logpdf(0.0, (1.0, 1.0)))
    assert float(new_trace.logjp) == pytest.approx(expected_new_logjp, abs=1e-3)
    assert float(weight) == pytest.approx(expected_new_logjp - prev_logjp, abs=1e-3)


def test_update_poisson_ranged_loop():
    # dyngenfn.rs:270-300: data-dependent address set via a poisson count.
    @gen
    def hierarchical_update(h):
        k = h.sample(poisson, 5.0, "k")
        for i in range(int(k)):
            h.sample(uniform, (0.0, 1.0), f"value/{i}")

    trace, _ = hierarchical_update.generate(key(8), (), trie_of(k=jnp.int64(3)))
    _, discard, weight = hierarchical_update.update(
        key(9), trace, (), ArgDiff.UNKNOWN, trie_of(k=jnp.int64(1)))
    assert discard.search("value/1") is not None
    assert discard.search("value/2") is not None
    expected = (float(poisson.logpdf(1, 5.0)) - float(poisson.logpdf(3, 5.0))
                - 2.0 * float(uniform.logpdf(0.5, (0.0, 1.0))))
    assert float(weight) == pytest.approx(expected)


# --- regenerate (dyngenfn.rs:304-388) ---------------------------------------

def test_regenerate():
    @gen
    def bar_mu(h, mu):
        return h.sample(normal, (mu, 1.0), "a")

    @gen
    def baz_mu(h, mu):
        return h.sample(normal, (mu, 1.0), "b")

    @gen
    def foo(h, mu):
        if h.sample(bernoulli, 0.4, "branch"):
            h.sample(normal, (mu, 1.0), "x")
            return h.trace(bar_mu, (mu,), "u")
        else:
            h.sample(normal, (mu, 1.0), "y")
            return h.trace(baz_mu, (mu,), "v")

    mu = 0.123
    trace, _ = foo.generate(key(10), (mu,), trie_of(branch=True))
    mask = select("branch")

    k = key(11)
    for i in range(10):
        prev_branch = bool(trace.data.read("branch"))
        prev_mu = mu
        k, k_mu, k_regen = jax.random.split(k, 3)
        mu = float(jax.random.uniform(k_mu, ()))
        trace, weight = foo.regenerate(
            k_regen, trace, (mu,), ArgDiff.UNKNOWN, mask)

        branch = bool(trace.data.read("branch"))

        def nlp(addr, m):
            return float(normal.logpdf(trace.data.read(addr), (m, 1.0)))

        if branch:
            expected_logjp = nlp("x", mu) + nlp("u/a", mu) + float(
                bernoulli.logpdf(True, 0.4))
        else:
            expected_logjp = nlp("y", mu) + nlp("v/b", mu) + float(
                bernoulli.logpdf(False, 0.4))
        assert float(trace.logjp) == pytest.approx(expected_logjp, abs=1e-3)

        # structure (dyngenfn.rs:347-357)
        if branch:
            assert trace.data.search("x") is not None
            assert not trace.data.search("u").is_leaf()
        else:
            assert trace.data.search("y") is not None
            assert not trace.data.search("v").is_leaf()
        leaves = sum(1 for _, s in trace.data if s.is_leaf())
        non_leaves = sum(1 for _, s in trace.data if not s.is_leaf())
        assert (leaves, non_leaves) == (2, 1)

        # weight: zero on branch change, delta-rescore otherwise
        # (dyngenfn.rs:359-386)
        expected_weight = 0.0
        if branch == prev_branch:
            if branch:
                expected_weight = (nlp("x", mu) + nlp("u/a", mu)
                                   - nlp("x", prev_mu) - nlp("u/a", prev_mu))
            else:
                expected_weight = (nlp("y", mu) + nlp("v/b", mu)
                                   - nlp("y", prev_mu) - nlp("v/b", prev_mu))
        assert float(weight) == pytest.approx(expected_weight, abs=1e-3)


def test_regenerate_empty_mask_means_all():
    # dyngenfn.rs:571: a leaf mask regenerates every address.
    @gen
    def two(h):
        h.sample(normal, (0.0, 1.0), "p")
        h.sample(normal, (0.0, 1.0), "q")

    tr = two.simulate(key(20), ())
    p0, q0 = float(tr.data.read("p")), float(tr.data.read("q"))
    new_tr, w = two.regenerate(key(21), tr, (), ArgDiff.NO_CHANGE, select())
    assert float(new_tr.data.read("p")) != p0
    assert float(new_tr.data.read("q")) != q0
    assert float(w) == pytest.approx(0.0)


# --- nested-address proposal model parses & runs (dyngenfn.rs:134-164) ------

def test_hierarchical_addresses():
    from modppl_tpu.dists import beta as beta_dist

    @gen
    def hyperprior(h, a, b):
        p = h.sample(beta_dist, (a, b), "prob_is_small")
        return h.sample(bernoulli, p, "is_small")

    @gen
    def model(h):
        if h.trace(hyperprior, (2.0, 2.0), "var"):
            return h.sample(normal, (0.0, 0.05), "y")
        else:
            return h.sample(normal, (0.0, 1.0), "y")

    tr = model.simulate(key(30), ())
    assert tr.data.search("var/prob_is_small") is not None
    assert tr.data.search("var / is_small") is not None
    assert tr.data.search("y") is not None
