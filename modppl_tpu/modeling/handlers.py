"""Effect handlers implementing the four GFI execution modes for the DSL.

JAX counterpart of the ``DynGenFnHandler`` enum
(modppl/src/modeling/dyngenfn.rs:39-487): four handler classes —
``SimulateHandler`` (dyngenfn.rs:41-46), ``GenerateHandler`` (49-58),
``UpdateHandler`` (61-76), ``RegenerateHandler`` (79-93) — each providing

- ``sample(dist, params, addr)``  ~ ``sample_at``  (dyngenfn.rs:100-275)
- ``trace(gen_fn, args, addr)``   ~ ``trace_at``   (dyngenfn.rs:283-449)
- ``gc()``                        ~ visitor-complement GC (dyngenfn.rs:454-486)

The weight-accounting case matrix (constrained × previous × ArgDiff) is
reproduced exactly; it is validated bit-for-bit against the regression
constants in modppl/tests/dyngenfn.rs (see tests/test_gfi_regression.py).

Differences from the reference:

- Randomness comes from an explicit threefry key; each address derives its
  own subkey via ``fold_in(key, stable_hash(addr))`` so sampling is
  order-independent, reproducible, and vmappable (replacing the ad-hoc
  ``ThreadRng`` at dyngenfn.rs:506,519,...).
- All values/logps are jnp arrays: run the handler on concrete inputs and it
  executes eagerly with exact reference semantics (including dynamic
  structure, discards and GC); run it under ``jit``/``vmap`` and the same
  code stages into a single fused XLA program (static-structure models;
  stochastic branching goes through the masked Cond combinator instead).
"""

import jax

from modppl_tpu.core.address import Selection, addr_hash
from modppl_tpu.core.gfi import ArgDiff, Trace
from modppl_tpu.core.trie import Trie


def addr_key_hash(addr):
    """Stable 31-bit hash of a normalized address, for PRNG key folding.

    FNV-1a over the normalized form — memoized, with a native C fast path
    (modppl_tpu/native); identical across the Python and C implementations.
    """
    return addr_hash(addr)


def addr_subkey(key, addr):
    """Derive the per-address sampling key: fold_in(key, stable_hash(addr))."""
    return jax.random.fold_in(key, addr_hash(addr))


class _Handler:
    """Common state & primitives; see the per-mode subclasses for semantics."""

    mode = None

    def __init__(self, key, trace):
        self.key = key
        self.tr = trace

    def sample(self, dist, params, addr):
        raise NotImplementedError

    def _draw(self, dist, params, addr):
        """Fresh draw at an unconstrained address (one stream per address
        per particle). The batched-particle tier overrides this
        (modeling/autobatch.py) to pull lane slices from ONE plate stream
        per address."""
        return dist.sample(self._subkey(addr), params)

    def _subkey(self, addr):
        """Key for a sub-generative-function call at ``addr``."""
        return addr_subkey(self.key, addr)

    def trace_call(self, gen_fn, args, addr):
        raise NotImplementedError

    def factor(self, logp, addr):
        """Add an explicit log-probability factor at `addr`.

        No reference counterpart (the reference's model class has no soft
        constraints); needed for marginalized models (e.g. summing a
        discrete gate out of the hierarchical regression so HMC/NUTS can
        run on the continuous remainder). Semantics: the factor always
        contributes to the trace's logjp; in generate/update/regenerate it
        always contributes (the delta) to the weight, like a constrained
        address.
        """
        raise NotImplementedError

    # ergonomic aliases: the reference DSL writes `dist(args) %= addr` and
    # `genfn(args) /= addr` (modppl-macros/src/address.rs:11-20).
    def trace(self, gen_fn, args, addr):
        return self.trace_call(gen_fn, args, addr)


class SimulateHandler(_Handler):
    """GenFn::simulate execution state (dyngenfn.rs:41-46)."""

    mode = "simulate"

    def sample(self, dist, params, addr):
        # dyngenfn.rs:104-113: sample, score, store weighted leaf.
        x = self._draw(dist, params, addr)
        logp = dist.logpdf(x, params)
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.tr.data.w_observe(addr, (), logp)

    def trace_call(self, gen_fn, args, addr):
        # dyngenfn.rs:287-296: recursive simulate; subtrace data inserted,
        # retv stored as the subtree's inner value.
        subtrace = gen_fn.simulate(self._subkey(addr), args)
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv


class GenerateHandler(_Handler):
    """GenFn::generate execution state (dyngenfn.rs:49-58)."""

    mode = "generate"

    def __init__(self, key, trace, constraints):
        super().__init__(key, trace)
        self.weight = 0.0
        self.constraints = constraints

    def sample(self, dist, params, addr):
        # dyngenfn.rs:115-141.
        choice = self.constraints.remove(addr)
        if choice is not None:
            x = choice.expect_inner(f"error: no value found in {addr}")
            logp = dist.logpdf(x, params)
            self.weight = self.weight + logp
        else:
            x = self._draw(dist, params, addr)
            logp = dist.logpdf(x, params)
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.constraints.remove(addr)  # a factor is never "unconsumed"
        self.tr.data.w_observe(addr, (), logp)
        self.weight = self.weight + logp

    def trace_call(self, gen_fn, args, addr):
        # dyngenfn.rs:298-320.
        choices = self.constraints.remove(addr)
        k = self._subkey(addr)
        if choices is not None:
            subtrace, d_weight = gen_fn.generate(k, args, choices)
            self.weight = self.weight + d_weight
        else:
            subtrace = gen_fn.simulate(k, args)
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv


class UpdateHandler(_Handler):
    """GenFn::update execution state (dyngenfn.rs:61-76).

    `diff` is shared mutable state: once any address is constrained or
    freshly sampled it flips to UNKNOWN, forcing downstream sites to rescore
    (matches the reference's `*diff = ArgDiff::Unknown` mutations).
    """

    mode = "update"

    def __init__(self, key, trace, diff, constraints):
        super().__init__(key, trace)
        self.diff = diff
        self.constraints = constraints
        self.weight = 0.0
        self.discard = Trie()
        self.visitor = Selection()

    def sample(self, dist, params, addr):
        # dyngenfn.rs:143-211.
        self.visitor.visit(addr)
        choice = self.constraints.remove(addr)
        if choice is not None:
            prev = self.tr.data.remove(addr)
            if prev is not None:
                self.weight = self.weight - prev.weight()
                self.discard.insert(addr, prev)
            x = choice.expect_inner(f"error: no value found in {addr}")
            logp = dist.logpdf(x, params)
            self.diff = ArgDiff.UNKNOWN
            self.weight = self.weight + logp
        else:
            prev = self.tr.data.remove(addr)
            if prev is not None:
                if self.diff is ArgDiff.NO_CHANGE:
                    # reuse value AND stored logp — no rescore (dyngenfn.rs:173-182)
                    x = prev.expect_inner(f"error: no value found in {addr}")
                    self.tr.data.insert(addr, prev)
                    return x
                elif self.diff is ArgDiff.UNKNOWN:
                    prev_logp = prev.weight()
                    x = prev.expect_inner(f"error: no value found in {addr}")
                    logp = dist.logpdf(x, params)
                    self.weight = self.weight + logp - prev_logp
                else:
                    raise ValueError("update: ArgDiff.EXTEND not supported")
            else:
                x = self._draw(dist, params, addr)
                logp = dist.logpdf(x, params)
                self.diff = ArgDiff.UNKNOWN
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.visitor.visit(addr)
        self.constraints.remove(addr)
        prev = self.tr.data.remove(addr)
        prev_logp = prev.weight() if prev is not None else 0.0
        self.tr.data.w_observe(addr, (), logp)
        self.weight = self.weight + logp - prev_logp

    def trace_call(self, gen_fn, args, addr):
        # dyngenfn.rs:321-391.
        self.visitor.visit(addr)
        choices = self.constraints.remove(addr)
        k = self._subkey(addr)
        if choices is not None:
            prev = self.tr.data.remove(addr)
            if prev is not None:
                subtrace_in = Trace(args, prev, None, prev.weight())
                subtrace, subdiscard, d_weight = gen_fn.update(
                    k, subtrace_in, args, self.diff, choices)
                if not subdiscard.is_empty():
                    self.discard.insert(addr, subdiscard)
                self.diff = ArgDiff.UNKNOWN
                self.weight = self.weight + d_weight
            else:
                subtrace, d_weight = gen_fn.generate(k, args, choices)
                self.diff = ArgDiff.UNKNOWN
                self.weight = self.weight + d_weight
        else:
            prev = self.tr.data.remove(addr)
            if prev is not None:
                if self.diff is ArgDiff.NO_CHANGE:
                    retv = prev.expect_inner(f"error: no value found in {addr}")
                    self.tr.data.insert(addr, prev)
                    return retv
                elif self.diff is ArgDiff.UNKNOWN:
                    subtrace_in = Trace(args, prev, None, prev.weight())
                    subtrace, subdiscard, d_weight = gen_fn.update(
                        k, subtrace_in, args, ArgDiff.UNKNOWN, Trie())
                    if not subdiscard.is_empty():
                        self.discard.insert(addr, subdiscard)
                    self.weight = self.weight + d_weight
                else:
                    raise ValueError("update: ArgDiff.EXTEND not supported")
            else:
                subtrace = gen_fn.simulate(k, args)
                self.diff = ArgDiff.UNKNOWN
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv

    def gc(self):
        """Visitor-complement garbage collection (dyngenfn.rs:456-470).

        Unvisited addresses move to the discard; their weight is subtracted.
        """
        schema = self.tr.data.schema()
        data, complement, complement_weight = self.tr.data.collect(
            schema.complement(self.visitor))
        assert self.visitor.all_visited(data.schema())
        self.tr.data = data
        self.discard.merge(complement)
        self.weight = self.weight - complement_weight


class RegenerateHandler(_Handler):
    """GenFn::regenerate execution state (dyngenfn.rs:79-93)."""

    mode = "regenerate"

    def __init__(self, key, trace, diff, mask):
        super().__init__(key, trace)
        self.diff = diff
        self.mask = mask
        self.weight = 0.0
        self.visitor = Selection()

    def sample(self, dist, params, addr):
        # dyngenfn.rs:213-275.
        self.visitor.visit(addr)
        submask = self.mask.search(addr)
        if submask is not None:
            self.tr.data.remove(addr)  # remove (if has previous)
            x = self._draw(dist, params, addr)
            logp = dist.logpdf(x, params)
            self.diff = ArgDiff.UNKNOWN
        else:
            prev = self.tr.data.remove(addr)
            if prev is not None:
                if self.diff is ArgDiff.NO_CHANGE:
                    x = prev.expect_inner(f"error: no value found in {addr}")
                    self.tr.data.insert(addr, prev)
                    return x
                elif self.diff is ArgDiff.UNKNOWN:
                    prev_logp = prev.weight()
                    x = prev.expect_inner(f"error: no value found in {addr}")
                    logp = dist.logpdf(x, params)
                    self.weight = self.weight + logp - prev_logp
                else:
                    raise ValueError("regenerate: ArgDiff.EXTEND not supported")
            else:
                x = self._draw(dist, params, addr)
                logp = dist.logpdf(x, params)
                self.diff = ArgDiff.UNKNOWN
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.visitor.visit(addr)
        prev = self.tr.data.remove(addr)
        prev_logp = prev.weight() if prev is not None else 0.0
        self.tr.data.w_observe(addr, (), logp)
        self.weight = self.weight + logp - prev_logp

    def trace_call(self, gen_fn, args, addr):
        # dyngenfn.rs:393-449.
        self.visitor.visit(addr)
        submask = self.mask.search(addr)
        k = self._subkey(addr)
        prev = self.tr.data.remove(addr)
        if prev is not None:
            if submask is not None:
                subtrace_in = Trace(args, prev, None, prev.weight())
                subtrace, d_weight = gen_fn.regenerate(
                    k, subtrace_in, args, self.diff, submask)
                self.diff = ArgDiff.UNKNOWN
                self.weight = self.weight + d_weight
            else:
                if self.diff is ArgDiff.NO_CHANGE:
                    retv = prev.expect_inner(f"error: no value found in {addr}")
                    self.tr.data.insert(addr, prev)
                    return retv
                elif self.diff is ArgDiff.UNKNOWN:
                    prev_weight = prev.weight()
                    subtrace, new_weight = gen_fn.generate(k, args, prev)
                    self.weight = self.weight + new_weight - prev_weight
                else:
                    raise ValueError("regenerate: ArgDiff.EXTEND not supported")
        else:
            subtrace = gen_fn.simulate(k, args)
            self.diff = ArgDiff.UNKNOWN
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv

    def gc(self):
        """Drop unvisited addresses; weight untouched (dyngenfn.rs:471-485)."""
        schema = self.tr.data.schema()
        data, _, _ = self.tr.data.collect(schema.complement(self.visitor))
        assert self.visitor.all_visited(data.schema())
        self.tr.data = data
