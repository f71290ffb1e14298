"""Weighted digital trie choice maps, registered as JAX pytrees.

JAX counterpart of the reference's ``Trie<V>`` (modppl/src/trie.rs) and
``DynTrie = Trie<Arc<dyn Any + Send + Sync>>`` (modppl/src/modeling/dyngenfn.rs:10).

Design differences from the reference, driven by XLA:

- **Values are pytree leaves** (jnp arrays / python scalars), not type-erased
  ``Arc<dyn Any>`` boxes: the trace is a pytree so every GFI method can be
  ``jit``/``vmap``/``scan``-compiled and sharded with ``pjit``.
- **Per-leaf log-probability** replaces the incremental weight bookkeeping at
  trie.rs:121-142,179: each leaf stores its own ``logp`` and ``weight()``
  computes the (traced, fused) sum over leaves. Under ``jit`` this compiles to
  a single XLA add-reduce rather than mutable f64 updates.
- Structure (the address skeleton) is static aux data; values and logps are
  dynamic leaves. ``vmap`` over a batch of tries batches every leaf.

Semantics preserved exactly: occupied-address writes raise (trie.rs:106,126,146),
``merge`` prefers other's values (trie.rs:187-202), ``collect(mask)`` splits
into (kept, collected, collected-weight) (trie.rs:221-247), ``schema()``
produces a Selection (trie.rs:205-215).

**Native core.** The reference's trie is compiled Rust; here the node type
and its hot walk/mutate methods (search/read/observe/w_observe/insert/
remove/weight and the inner-value ops) are a C extension type
(modppl_tpu/native/ctrie.c) that ``Trie`` subclasses — the eager
interpreter's per-sample trie traffic runs without Python dispatch. The
pure-Python base below has identical semantics (asserted method-for-method
by tests/test_native_trie.py) and is used when the extension isn't built.
"""

import jax
import jax.numpy as jnp

from modppl_tpu.core.address import Selection, addr_components

_EMPTY = object()  # sentinel: "no inner value" (distinct from a stored None)


def _sum_logp(logp):
    """Reduce a leaf logp over its (logical) axes; scalars pass through."""
    if getattr(logp, "ndim", 0):
        return jnp.sum(logp)
    return logp


def _values_equal(a, b):
    try:
        return bool(jnp.all(jnp.asarray(a) == jnp.asarray(b)))
    except (TypeError, ValueError):
        return a == b


class _PyTrieBase:
    """Pure-Python node core: the fallback for the C extension type.

    Hot methods only — the long-tail API lives in ``_TrieCommon``. Kept
    semantically identical to native/ctrie.c (same errors, same pruning).
    """

    __slots__ = ("children", "value", "logp", "dist")

    def __init__(self):
        self.children = {}
        self.value = _EMPTY
        self.logp = 0.0
        self.dist = None  # Distribution that sampled this leaf (static metadata)

    # ---- basic structure --------------------------------------------------

    def is_empty(self):
        """No inner value and no descendants (trie.rs:36-38)."""
        return not self.children and self.value is _EMPTY

    def is_leaf(self):
        """Inner value but no descendants (trie.rs:41-43)."""
        return not self.children and self.value is not _EMPTY

    def __len__(self):
        return len(self.children)

    def has_inner(self):
        return self.value is not _EMPTY

    def inner(self):
        """Inner value or None (trie.rs:50-52)."""
        return None if self.value is _EMPTY else self.value

    def take_inner(self):
        """Remove and return the inner value, or None (trie.rs:55-57)."""
        v = self.inner()
        self.value = _EMPTY
        return v

    def replace_inner(self, value):
        """Set the inner value, returning the previous one or None (trie.rs:60-62).

        Does not touch `logp` — a sub-genfn's return value carries no weight
        (dyngenfn.rs:293 stores retv via replace_inner without weight).
        """
        prev = self.inner()
        self.value = value
        return prev

    def expect_inner(self, msg):
        if self.value is _EMPTY:
            raise KeyError(msg)
        return self.value

    # ---- weight -----------------------------------------------------------

    def weight(self):
        """Sum of all leaf logps below (and at) this node (trie.rs:85-87).

        Traced: under jit this is one fused reduction over the trace's
        per-address logp leaves — the XLA replacement for the reference's
        incremental f64 bookkeeping. A leaf's logp may itself be an array
        (plated sub-tries from the Map combinator store one logp per plate
        element); leaf-local axes are summed.
        """
        acc = _sum_logp(self.logp)
        for sub in self.children.values():
            acc = acc + sub.weight()
        return acc

    # ---- search / read ----------------------------------------------------

    def search(self, addr):
        """Descendant node at `addr`, or None (trie.rs:90-101)."""
        node = self
        for c in addr_components(addr):
            node = node.children.get(c)
            if node is None:
                return None
        return node

    def read(self, addr):
        """Inner value at `addr`; raises on a missing address (dyngenfn.rs:17-35)."""
        node = self.search(addr)
        if node is None:
            raise KeyError(f'read: failed when searching empty address "{addr}"')
        return node.expect_inner(f'read: no value found at address "{addr}"')

    # ---- writes -----------------------------------------------------------

    def w_observe(self, addr, value, logp, dist=None):
        """Store a weighted `value` leaf at `addr`; raises if occupied (trie.rs:122-138).

        `dist` optionally records which Distribution sampled the value —
        static metadata used by gradient-based inference to derive
        unconstraining bijectors (no reference counterpart).
        """
        comps = addr_components(addr)
        node = self
        for c in comps[:-1]:
            node = node.children.setdefault(c, type(self)())
        last = comps[-1]
        if last in node.children:
            raise KeyError(
                f'w_observe: attempted to put into occupied address "{last}"')
        leaf = type(self)()
        leaf.value = value
        leaf.logp = logp
        leaf.dist = dist
        node.children[last] = leaf

    def insert(self, addr, sub):
        """Insert sub-trie at `addr`; raises if occupied (trie.rs:141-159)."""
        comps = addr_components(addr)
        node = self
        for c in comps[:-1]:
            node = node.children.setdefault(c, type(self)())
        last = comps[-1]
        if last in node.children:
            raise KeyError(
                f'insert: attempted to put into occupied address "{last}"')
        node.children[last] = sub

    def remove(self, addr):
        """Remove and return the sub-trie at `addr`, or None (trie.rs:162-183).

        Empty intermediate nodes are pruned, as in the reference.
        """
        comps = addr_components(addr)
        path = []
        node = self
        for c in comps:
            path.append(node)
            node = node.children.get(c)
            if node is None:
                return None
        del path[-1].children[comps[-1]]
        for i in range(len(comps) - 1, 0, -1):
            if not path[i].is_empty():
                break
            del path[i - 1].children[comps[i - 1]]
        return node


try:
    from modppl_tpu.native import ctrie as _native_trie
except ImportError:  # pragma: no cover - import-order edge
    _native_trie = None

if _native_trie is not None:
    _native_trie.configure(_EMPTY, addr_components, _sum_logp)
    _TrieBase = _native_trie.CTrieBase
    HAVE_NATIVE_TRIE = True
else:
    _TrieBase = _PyTrieBase
    HAVE_NATIVE_TRIE = False


class _TrieCommon:
    """Long-tail trie API shared by the native and pure-Python bases."""

    __slots__ = ()

    @classmethod
    def leaf(cls, value, logp=0.0, dist=None):
        """A leaf node holding `value` with weight `logp` (trie.rs:26-32)."""
        t = cls()
        t.value = value
        t.logp = logp
        t.dist = dist
        return t

    def observe(self, addr, value):
        """Store an unweighted `value` leaf at `addr`; raises if occupied (trie.rs:104-119)."""
        self.w_observe(addr, value, 0.0)

    def __iter__(self):
        """Iterate (addr, sub-trie) over direct descendants (trie.rs:70-72)."""
        return iter(self.children.items())

    def __contains__(self, addr):
        return self.search(addr) is not None

    def __getitem__(self, addr):
        return self.read(addr)

    def __setitem__(self, addr, value):
        self.observe(addr, value)

    def merge(self, other):
        """Merge `other` into self, preferring other's values (trie.rs:187-202)."""
        for addr, othersub in list(other.children.items()):
            if othersub.is_leaf():
                self.w_observe(addr, othersub.value, othersub.logp, othersub.dist)
            else:
                mine = self.children.get(addr)
                if mine is not None:
                    mine.merge(othersub)
                else:
                    self.insert(addr, othersub)

    # ---- schema / collect -------------------------------------------------

    def schema(self):
        """Selection describing the address structure (trie.rs:205-215)."""
        sel = Selection()
        for addr, sub in self.children.items():
            if sub.is_leaf():
                sel.visit(addr)
            else:
                sel.insert(addr, sub.schema())
        return sel

    def collect(self, mask):
        """Split self by a Selection `mask` (trie.rs:221-247).

        Returns (kept, collected, collected_weight): `collected` holds the
        values under `mask`, `kept` holds the complement; `collected_weight`
        is collected.weight(). Consumes self (both results may alias self's
        nodes); matches the move semantics of the reference.
        """
        cls = type(self)
        collected = cls()
        if self.schema() == mask:
            return cls(), self, self.weight()
        if not mask.is_leaf():
            for addr, submask in mask:
                sub = self.remove(addr)
                if sub is None:
                    raise KeyError(f'collect: mask address "{addr}" not in trie')
                if submask.is_leaf():
                    collected.insert(addr, sub)
                else:
                    sub, subcollected, _ = sub.collect(submask)
                    if not sub.is_empty():
                        self.insert(addr, sub)
                    if not subcollected.is_empty():
                        collected.insert(addr, subcollected)
        return self, collected, collected.weight()

    # ---- conversion / comparison ------------------------------------------

    def copy(self):
        """Structural copy (arrays shared — they are immutable in JAX)."""
        t = type(self)()
        t.value = self.value
        t.logp = self.logp
        t.dist = self.dist
        t.children = {k: v.copy() for k, v in self.children.items()}
        return t

    def as_dict(self):
        """Nested plain-dict view {addr: value|dict} (for printing/serialization)."""
        out = {}
        if self.value is not _EMPTY:
            out["__value__"] = self.value
        for k, v in self.children.items():
            out[k] = v.inner() if v.is_leaf() else v.as_dict()
        return out

    @classmethod
    def from_dict(cls, d):
        """Build an unweighted Trie from a nested dict of {component: value|dict}."""
        t = cls()
        for k, v in d.items():
            if isinstance(v, dict):
                t.insert(k, cls.from_dict(v))
            else:
                t.observe(k, v)
        return t

    def addresses(self, prefix=""):
        """All leaf-value addresses, ' / '-joined, sorted."""
        out = []
        for k in sorted(self.children):
            sub = self.children[k]
            path = k if not prefix else f"{prefix} / {k}"
            if sub.has_inner():
                out.append(path)
            if sub.children:
                out.extend(sub.addresses(path))
        return out

    def __eq__(self, other):
        if not isinstance(other, _TrieCommon):
            return NotImplemented
        if set(self.children) != set(other.children):
            return False
        if (self.value is _EMPTY) != (other.value is _EMPTY):
            return False
        if self.value is not _EMPTY:
            if not _values_equal(self.value, other.value):
                return False
        if not _values_equal(self.logp, other.logp):
            return False
        return all(self.children[k] == other.children[k] for k in self.children)

    __hash__ = None

    def __repr__(self):
        if self.is_leaf():
            return f"Trie.leaf({self.value!r}, logp={self.logp!r})"
        return f"Trie({self.as_dict()!r})"


class Trie(_TrieCommon, _TrieBase):
    """Hierarchical choice map: children dict + optional inner value + leaf logp."""

    __slots__ = ()


class PurePythonTrie(_TrieCommon, _PyTrieBase):
    """Always-Python variant, for native/pure parity tests."""

    __slots__ = ()


# ---- pytree registration ---------------------------------------------------
#
# Children are flattened in sorted-key order so that two tries with the same
# address set always produce the same leaf ordering (required for vmap/scan
# batching and for select-based accept/reject in compiled MH).

def _trie_flatten(t):
    keys = tuple(sorted(t.children))
    has_value = t.value is not _EMPTY
    children_leaves = tuple(t.children[k] for k in keys)
    if has_value:
        leaves = (t.value, t.logp) + children_leaves
    else:
        leaves = (t.logp,) + children_leaves
    return leaves, (keys, has_value, t.dist)


def _make_unflatten(cls):
    def _trie_unflatten(aux, leaves):
        keys, has_value, dist = aux
        t = cls()
        t.dist = dist
        idx = 0
        if has_value:
            t.value = leaves[0]
            idx = 1
        t.logp = leaves[idx]
        idx += 1
        t.children = dict(zip(keys, leaves[idx:]))
        return t

    return _trie_unflatten


jax.tree_util.register_pytree_node(Trie, _trie_flatten, _make_unflatten(Trie))
jax.tree_util.register_pytree_node(
    PurePythonTrie, _trie_flatten, _make_unflatten(PurePythonTrie))
