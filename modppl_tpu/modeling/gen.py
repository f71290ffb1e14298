"""The ``@gen`` decorator: probabilistic functions as generative functions.

JAX counterpart of ``DynGenFn`` (modppl/src/modeling/dyngenfn.rs:491-584)
plus the ``dyngen!`` proc-macro front-end (modppl-macros/src/lib.rs:21-114).
No operator rewriting is needed in Python — the macro's ``dist(args) %= addr``
becomes ``h.sample(dist, args, addr)`` and ``genfn(args) /= addr`` becomes
``h.trace(genfn, args, addr)``, where ``h`` is the handler passed as the
function's first parameter:

    @gen
    def line_model(h, xs):
        slope = h.sample(normal, (0., 1.), "slope")
        intercept = h.sample(normal, (0., 2.), "intercept")
        return h.trace(obs_model, (slope, intercept, xs), "ys")

Execution modes: run any GFI method on concrete inputs and it executes
eagerly with exact reference semantics (dynamic structure, discards, GC);
wrap it in ``jit``/``vmap`` and the identical handler code stages into one
fused XLA program — valid whenever the model's Python control flow does not
depend on traced values (use the Cond/Switch combinators for stochastic
branching under jit).

Proposal convention: where the reference passes ``Weak<Trace>`` as the first
argument (macros/proposal.rs:4-28), here the previous trace is simply the
first element of ``args`` — a plain immutable pytree.
"""

import jax

from modppl_tpu.core.gfi import GenFn, Trace
from modppl_tpu.core.trie import Trie
from modppl_tpu.modeling.handlers import (
    GenerateHandler,
    RegenerateHandler,
    SimulateHandler,
    UpdateHandler,
)


def _as_args_tuple(args):
    return args if isinstance(args, tuple) else (args,)


class Gen(GenFn):
    """A generative function defined by a Python body over a handler.

    Wraps ``fn(handler, *args) -> retv`` and implements the four GFI methods
    by constructing the matching handler, running the body, then finalizing
    (``logjp = trace.data.weight()``; residual-constraint errors; GC) exactly
    as DynGenFn does (dyngenfn.rs:503-584).
    """

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "gen_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __repr__(self):
        return f"Gen({self.__name__})"

    def simulate(self, key, args):
        # dyngenfn.rs:504-514. named_scope: SURVEY.md §5 tracing — per-GFI-
        # method profiler annotations (no-op outside a jax.profiler trace).
        with jax.named_scope(f"{self.__name__}.simulate"):
            g = SimulateHandler(key, Trace(args, Trie(), None, 0.0))
            retv = self.fn(g, *_as_args_tuple(args))
        trace = g.tr
        trace.set_retv(retv)
        trace.logjp = trace.data.weight()
        return trace

    def generate(self, key, args, constraints):
        # dyngenfn.rs:516-533
        constraints = constraints.copy()
        constraints.take_inner()  # in case constraints came from a proposal
        g = GenerateHandler(key, Trace(args, Trie(), None, 0.0), constraints)
        with jax.named_scope(f"{self.__name__}.generate"):
            retv = self.fn(g, *_as_args_tuple(args))
        if not g.constraints.is_empty():
            raise ValueError(
                "generate error: not all constraints were consumed! residual: "
                f"{g.constraints.addresses()}")
        trace = g.tr
        trace.logjp = trace.data.weight()
        trace.set_retv(retv)
        return trace, g.weight

    def update(self, key, trace, args, argdiff, constraints):
        # dyngenfn.rs:535-561
        constraints = constraints.copy()
        constraints.take_inner()
        # the handler mutates the choice trie structurally; copy so the
        # caller's trace (e.g. MH's prev_trace, mh.rs:15) stays intact.
        trace = Trace(args, trace.data.copy(), trace.retv, trace.logjp)
        g = UpdateHandler(key, trace, argdiff, constraints)
        with jax.named_scope(f"{self.__name__}.update"):
            retv = self.fn(g, *_as_args_tuple(args))
        g.gc()  # subtract complement weight, move complement into discard
        if not g.constraints.is_empty():
            raise ValueError(
                "update error: not all constraints were consumed! residual: "
                f"{g.constraints.addresses()}")
        trace = g.tr
        trace.logjp = trace.data.weight()
        trace.set_retv(retv)
        return trace, g.discard, g.weight

    def regenerate(self, key, trace, args, argdiff, selection):
        # dyngenfn.rs:563-584; an empty (leaf) mask means "regenerate all"
        # (dyngenfn.rs:571).
        mask = trace.data.schema() if selection.is_leaf() else selection
        trace = Trace(args, trace.data.copy(), trace.retv, trace.logjp)
        g = RegenerateHandler(key, trace, argdiff, mask)
        with jax.named_scope(f"{self.__name__}.regenerate"):
            retv = self.fn(g, *_as_args_tuple(args))
        g.gc()
        trace = g.tr
        trace.logjp = trace.data.weight()
        trace.set_retv(retv)
        return trace, g.weight


def gen(fn):
    """Decorator: turn ``fn(handler, *args)`` into a ``Gen`` generative function."""
    return Gen(fn)
