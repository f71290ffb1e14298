"""Automatic batched-particle execution of per-particle ``@gen`` kernels.

The batched-particle tier (inference/vsmc.batched_particle_filter) treats
the particle axis as an ordinary array axis: unconstrained latents sample
from ONE threefry counter stream per address (~3x fewer PRNG blocks per
step than per-particle ``split``/``fold_in`` at 10^6 particles), and
constrained scores broadcast to per-particle ``(n,)`` weights. Round 2
required hand-written batch-aware model variants (``plate()`` addresses,
reshaped math); this module derives the batched execution AUTOMATICALLY
from the ordinary per-particle kernel.

Two-pass scheme (both passes trace into the SAME jit program):

1. **Record pass** — the body runs once under the same vmap structure
   as the real pass, with a recording handler that notes every
   fresh-draw site whose params are lane-INDEPENDENT (plain ambient
   values, not batch tracers — the split is decided by the actual trace).
   Outputs are discarded, so XLA dead-code-eliminates everything except
   the recorded params; device cost ~zero.
2. **Plate pre-draw + vmap pass** — each recorded address's full ``(n,)``
   plate sample is drawn OUTSIDE the vmap (one ``sample_batch`` per
   address from the shared ``addr_subkey`` stream — bitwise the values a
   hand-written ``plate(dist, n)`` site produces), then the body runs
   per-particle under ``vmap`` with the plate dict passed ``in_axes=0``:
   every lane receives its slice by batching, NOT by an explicit
   ``xs[i]`` gather (a 2^20-lane gather per address for every address
   of every particle).

The model BODY always runs per-particle — indexing/stacking semantics are
untouched, so any static-structure per-particle ``@gen`` kernel
qualifies. Sites whose params are themselves per-particle (batched —
e.g. a latent whose location is the previous state) cannot share a plate
draw; the recorder skips them and they fall back to one
``fold_in(addr_key, lane)`` stream per lane (the per-particle cost, for
that site only). Sub-``trace`` calls fold the lane index the same way.

Wrap a ScanKernel with :func:`auto_batch_scan_kernel` or pass
``auto_batch=True`` to ``batched_particle_filter``.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.core.gfi import Trace
from modppl_tpu.core.trie import Trie
from modppl_tpu.modeling.handlers import GenerateHandler, addr_subkey

def _any_batched(tree):
    """True if any leaf is a vmap batch tracer (per-lane value).

    Name-based: the class lives at jax._src.interpreters.batching (moved
    across jax versions). Failure modes are safe by construction: a
    false positive only disables the plate sharing for that site (slower,
    correct); a false negative records a batch tracer whose use outside
    the vmap raises jax's leaked-tracer error (loud, never silently
    wrong).
    """
    return any(isinstance(x, jax.core.Tracer)
               and type(x).__name__ == "BatchTracer"
               for x in jax.tree_util.tree_leaves(tree))


class LaneGenerateHandler(GenerateHandler):
    """GenerateHandler for one lane of the auto-batched vmap.

    ``lane = (i, n)``; ``record`` (pass 1) collects fresh-draw sites;
    ``pool`` (pass 2) maps addresses to this lane's pre-drawn plate value.
    """

    def __init__(self, key, trace, constraints, lane, record=None, pool=None):
        super().__init__(key, trace, constraints)
        self.lane = lane
        self.record = record
        self.pool = pool

    def _draw(self, dist, params, addr):
        i, n = self.lane
        if self.record is not None:
            if not _any_batched(params):
                # lane-independent params: the site can share one plate
                # stream; params here are ambient-trace values, valid for
                # the pre-draw outside the vmap
                self.record[addr] = (dist, params)
        elif self.pool is not None and addr in self.pool:
            # only verified lane-independent sites were recorded, so the
            # pre-drawn plate value applies unconditionally
            return self.pool[addr]
        # per-lane counter stream: pass 1 (values discarded), or a site
        # whose params depend on per-lane state
        return dist.sample(
            jax.random.fold_in(addr_subkey(self.key, addr), i), params)

    def _subkey(self, addr):
        # sub-genfn calls get per-lane streams (correct, not plate-shared)
        return jax.random.fold_in(addr_subkey(self.key, addr), self.lane[0])


def _lane_generate(gen_fn, key, args, constraints, i, n, record=None,
                   pool=None):
    """Gen.generate (modeling/gen.py:72-86) with the lane handler."""
    constraints = constraints.copy()
    constraints.take_inner()
    g = LaneGenerateHandler(key, Trace(args, Trie(), None, 0.0), constraints,
                            lane=(i, n), record=record, pool=pool)
    retv = gen_fn.fn(g, *args)
    if not g.constraints.is_empty():
        raise ValueError(
            "generate error: not all constraints were consumed! residual: "
            f"{g.constraints.addresses()}")
    trace = g.tr
    trace.logjp = trace.data.weight()
    trace.set_retv(retv)
    return trace, g.weight


def _record_pools(gen_fn, key, lane_args_fn, vmap_args, constraints, n):
    """Record pass (vmapped, outputs discarded -> DCE'd) + plate pre-draws.

    Running the record pass under the SAME vmap structure as the real
    pass means unbatched params are plain ambient values (directly
    reusable for the pre-draw) while per-lane params are batch tracers
    the recorder skips — the batched/unbatched split is decided by the
    actual trace, not by re-deriving it.
    """
    rec = {}
    jax.vmap(lambda i, *v: _lane_generate(
        gen_fn, key, lane_args_fn(*v), constraints, i, n, record=rec)
    )(jnp.arange(n), *vmap_args)
    return {addr: dist.sample_batch(addr_subkey(key, addr), (n,), params)
            for addr, (dist, params) in rec.items()}


class AutoBatchedInit:
    """Batch-aware init: args ``(*per_particle_args, n)`` (the
    batched_smc_init convention), generate returns per-particle weights."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch({inner.__name__})"

    def __repr__(self):
        return f"AutoBatchedInit({self.inner!r})"

    def generate(self, key, args, constraints):
        *a, n = args
        a = tuple(a)
        with jax.named_scope(f"{self.__name__}.generate"):
            pools = _record_pools(self.inner, key, lambda: a, (),
                                  constraints, n)
            return jax.vmap(
                lambda i, pool: _lane_generate(self.inner, key, a,
                                               constraints, i, n, pool=pool)
            )(jnp.arange(n), pools)


class AutoBatchedStep:
    """Batch-aware step: args ``(t, state)`` with ``state`` batched on its
    leading axis (the batched_smc_step convention)."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch({inner.__name__})"

    def __repr__(self):
        return f"AutoBatchedStep({self.inner!r})"

    def generate(self, key, args, constraints):
        t, state = args
        n = jax.tree_util.tree_leaves(state)[0].shape[0]
        with jax.named_scope(f"{self.__name__}.generate"):
            pools = _record_pools(self.inner, key, lambda st: (t, st),
                                  (state,), constraints, n)
            return jax.vmap(
                lambda i, st, pool: _lane_generate(self.inner, key, (t, st),
                                                   constraints, i, n,
                                                   pool=pool)
            )(jnp.arange(n), state, pools)

    def generate_constrained_batched(self, key, args, constraints_batched):
        """Per-lane-constrained generate: ``constraints_batched`` carries
        PER-PARTICLE leaves (leading axis n) — the guided-filter case where
        a proposal's choices constrain each lane differently. The record
        pass and real pass both vmap the constraint trie with
        ``in_axes=0``."""
        t, state = args
        n = jax.tree_util.tree_leaves(state)[0].shape[0]
        with jax.named_scope(f"{self.__name__}.generate_constrained"):
            rec = {}
            jax.vmap(lambda i, st, cons: _lane_generate(
                self.inner, key, (t, st), cons, i, n, record=rec)
            )(jnp.arange(n), state, constraints_batched)
            pools = {addr: dist.sample_batch(addr_subkey(key, addr), (n,),
                                             params)
                     for addr, (dist, params) in rec.items()}
            return jax.vmap(
                lambda i, st, cons, pool: _lane_generate(
                    self.inner, key, (t, st), cons, i, n, pool=pool)
            )(jnp.arange(n), state, constraints_batched, pools)


class AutoBatchedPropose:
    """Batched ``propose`` over a per-particle proposal Gen.

    ``propose(key, (t, state, *shared), n)`` runs the proposal once per
    lane under vmap with the plate-shared counter streams of the record/
    pool scheme, returning ``(choices, logjp)`` with every choice leaf and
    the log-joint batched on axis 0 — the batched-tier counterpart of
    ``Gen.propose`` (core/gfi.py:113-116; propose = simulate + (data,
    logjp), and generate with empty constraints IS simulate)."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch_propose({inner.__name__})"

    def propose(self, key, args, n):
        t, state, *shared = args
        shared = tuple(shared)
        with jax.named_scope(f"{self.__name__}.propose"):
            rec = {}
            jax.vmap(lambda i, st: _lane_generate(
                self.inner, key, (t, st) + shared, Trie(), i, n,
                record=rec)
            )(jnp.arange(n), state)
            pools = {addr: dist.sample_batch(addr_subkey(key, addr), (n,),
                                             params)
                     for addr, (dist, params) in rec.items()}
            traces, _ = jax.vmap(
                lambda i, st, pool: _lane_generate(
                    self.inner, key, (t, st) + shared, Trie(), i, n,
                    pool=pool)
            )(jnp.arange(n), state, pools)
            return traces.data, traces.logjp


def auto_batch_scan_kernel(kernel):
    """Derive a batched-particle ScanKernel from a per-particle one.

    ``batched_particle_filter(key, kernel, ..., auto_batch=True)`` (which
    calls this) runs the fast tier on any ordinary per-particle kernel —
    no hand-written ``plate()`` model variants needed.
    """
    from modppl_tpu.inference.vsmc import ScanKernel

    return ScanKernel(AutoBatchedInit(kernel.init),
                      AutoBatchedStep(kernel.step))
