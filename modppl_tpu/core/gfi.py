"""The Generative Function Interface (GFI).

JAX counterpart of the reference's core trait (modppl/src/gfi.rs):
``Trace`` (gfi.rs:5-29), ``GenFn`` with
simulate/generate/update/regenerate/call/propose/assess (gfi.rs:49-92), and
``ArgDiff`` (gfi.rs:100-112).

Differences driven by the compiled (XLA) execution model:

- Every method takes an explicit PRNG **key** first (counter-based threefry
  keys replace the reference's ad-hoc ``ThreadRng::default()``, e.g.
  dyngenfn.rs:506): required for reproducibility and for ``vmap`` over
  particles/chains.
- ``Trace`` is a registered pytree, so traces flow through
  ``jit``/``vmap``/``lax.scan``/``shard_map`` unchanged. ``Data`` is
  generalized to "any pytree of choices": trie-based DSL models, tuple-buffer
  hand-coded models and vector-buffer sequential models all run under the
  same inference functions (the reference's crucial architectural property,
  lib.rs:2-5).
- Proposals receive the previous trace **by value** as the first element of
  their args (replacing the ``Weak<Trace>`` aliasing convention at mh.rs:12,
  macros/proposal.rs:4-28 — cheap here because arrays are immutable/shared).

Like the reference, this interface deliberately does not implement Gen's
retdiff or choice gradients (README.md:44); gradients of ``logjp`` come for
free from JAX autodiff instead and power the HMC/NUTS/VI extensions.
"""

import enum

import jax


class ArgDiff(enum.Enum):
    """Incremental-update hint (gfi.rs:100-112)."""

    NO_CHANGE = "no_change"
    UNKNOWN = "unknown"
    # Vector-valued data being appended (used by the particle filter).
    EXTEND = "extend"


class Trace:
    """Record of one probabilistic execution (gfi.rs:5-29).

    Fields: ``args``, ``data`` (all random choices), ``retv``, ``logjp``
    (log joint probability). Registered as a pytree: args/data/retv/logjp are
    dynamic leaves, so traces batch under vmap and shard under pjit.
    """

    __slots__ = ("args", "data", "retv", "logjp")

    def __init__(self, args, data, retv, logjp):
        self.args = args
        self.data = data
        self.retv = retv
        self.logjp = logjp

    def set_retv(self, v):
        self.retv = v

    def copy(self):
        data = self.data.copy() if hasattr(self.data, "copy") else jax.tree_util.tree_map(lambda x: x, self.data)
        return Trace(self.args, data, self.retv, self.logjp)

    def __repr__(self):
        return (f"Trace(args={self.args!r}, retv={self.retv!r}, "
                f"logjp={self.logjp!r}, data={self.data!r})")


def _trace_flatten(tr):
    return (tr.args, tr.data, tr.retv, tr.logjp), None


def _trace_unflatten(aux, leaves):
    return Trace(*leaves)


jax.tree_util.register_pytree_node(Trace, _trace_flatten, _trace_unflatten)


class GenFn:
    """Interface for functions that support the standard inference library.

    Mirrors trait ``GenFn<Args,Data,Ret>`` (gfi.rs:49-92). Any object
    implementing ``simulate``/``generate``/``update`` (and optionally
    ``regenerate``) composes with every inference procedure in
    ``modppl_tpu.inference``. ``Data`` is any pytree of choices.
    """

    def simulate(self, key, args):
        """Execute the generative function, returning a sampled Trace (gfi.rs:52)."""
        raise NotImplementedError

    def generate(self, key, args, constraints):
        """Execute consistent with `constraints`; returns (trace, weight) (gfi.rs:55)."""
        raise NotImplementedError

    def update(self, key, trace, args, argdiff, constraints):
        """Update a trace with forward choices; returns (trace, discard, weight) (gfi.rs:58-63)."""
        raise NotImplementedError

    def regenerate(self, key, trace, args, argdiff, selection):
        """Regenerate a masked subset of a trace; returns (trace, weight) (gfi.rs:66-73)."""
        raise NotImplementedError("regenerate: impl not found")

    # -- derived methods (gfi.rs:76-91) --------------------------------------

    def call(self, key, args):
        """Sample a trace and return its return value (gfi.rs:76-78)."""
        return self.simulate(key, args).retv

    def propose(self, key, args):
        """Sample (data, logjp) from the function (gfi.rs:81-84)."""
        trace = self.simulate(key, args)
        return trace.data, trace.logjp

    def assess(self, key, args, constraints):
        """Conditional log-probability of fully-proposed `constraints` (gfi.rs:87-90)."""
        _, weight = self.generate(key, args, constraints)
        return weight
