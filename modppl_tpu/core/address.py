"""Hierarchical string addresses and address-set masks (selections).

JAX counterpart of the reference's address layer
(modppl/src/address.rs):

- ``split_addr``   ~ ``SplitAddr::from_addr`` (address.rs:24-37): split an
  address at the *first* ``/`` into ``(term,)`` or ``(first, rest)``, trimming
  whitespace around components.
- ``normalize_addr`` ~ ``normalize_addr`` (address.rs:39-48): canonicalize
  separators to ``" / "``.
- ``Selection``    ~ ``AddrMap`` (address.rs:51-146): a recursive string map
  used both as a *mask* (regenerate selections) and a *visitor* record
  (garbage collection during update/regenerate).

Addresses are always static Python strings fixed at trace time (they are
compile-time constants in every reference model), so none of this code ever
appears inside an XLA computation — it only shapes the pytree structure that
XLA compiles over.
"""

import re
from functools import lru_cache

try:  # native fast path (modppl_tpu/native/addrops.c); Python fallback below
    from modppl_tpu.native import addrops as _native
except ImportError:  # pragma: no cover - import-order edge
    _native = None

_ADDR_RE = re.compile(r"^(.*?)/(.*)$")  # same spec as address.rs:19


def _py_split_addr(addr):
    m = _ADDR_RE.match(addr)
    if m is None:
        return (addr.strip(),)
    return (m.group(1).strip(), m.group(2))


@lru_cache(maxsize=65536)
def _py_normalize_addr(addr):
    parts = _py_split_addr(addr)
    if len(parts) == 1:
        return parts[0]
    return f"{parts[0]} / {_py_normalize_addr(parts[1])}"


@lru_cache(maxsize=65536)
def _py_components(addr):
    out = []
    while True:
        parts = _py_split_addr(addr)
        out.append(parts[0])
        if len(parts) == 1:
            return tuple(out)
        addr = parts[1]


@lru_cache(maxsize=65536)
def _py_addr_hash(addr):
    """31-bit FNV-1a over the normalized address (same constants as the
    native module)."""
    h = 2166136261
    for b in _py_normalize_addr(addr).encode():
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


if _native is not None:
    split_addr = _native.split_addr
    normalize_addr = _native.normalize_addr
    addr_components = _native.addr_components
    addr_hash = _native.addr_hash
else:
    split_addr = _py_split_addr
    normalize_addr = _py_normalize_addr
    addr_components = _py_components
    addr_hash = _py_addr_hash

# split_addr: split at the first '/' into ('term',) or (first, rest) —
# mirrors SplitAddr::from_addr (address.rs:24-37). normalize_addr:
# canonicalize separators to " / " (address.rs:39-48). addr_hash: memoized
# 31-bit FNV-1a over the normalized form, used for PRNG key folding.


class Selection:
    """A recursive set of addresses; used as a mask and as a visitor record.

    Mirrors AddrMap (address.rs:51-146). A `Selection` node with no children
    is a *leaf*: as a mask it selects the entire subtree below its path.
    """

    __slots__ = ("children",)

    def __init__(self, addrs=()):
        self.children = {}
        for a in addrs:
            self.visit(a)

    @staticmethod
    def all():
        """Leaf selection at the root: selects everything (mask semantics)."""
        return Selection()

    def is_leaf(self):
        return not self.children  # address.rs:63

    def search(self, addr):
        """Descendant at `addr`, or None (address.rs:67-81)."""
        parts = split_addr(addr)
        if len(parts) == 1:
            return self.children.get(parts[0])
        sub = self.children.get(parts[0])
        return sub.search(parts[1]) if sub is not None else None

    def insert(self, addr, sub):
        """Insert a descendant selection at a single-component `addr` (address.rs:84-86)."""
        self.children[addr] = sub

    def visit(self, addr):
        """Add `addr` (all components) to the selection (address.rs:105-119)."""
        parts = split_addr(addr)
        sub = self.children.setdefault(parts[0], Selection())
        if len(parts) == 2:
            sub.visit(parts[1])

    def all_visited(self, other):
        """True if every address in `other` (or an ancestor) is in self (address.rs:91-102)."""
        for addr, sub in other.children.items():
            mine = self.search(addr)
            if mine is None:
                return False
            if not mine.is_leaf() and not mine.all_visited(sub):
                return False
        return True

    def complement(self, mask):
        """Addresses of self absent from `mask` (address.rs:122-140).

        A leaf in `mask` covers its whole subtree; a leaf in self intersected
        with a non-leaf mask contributes nothing (matches reference).
        """
        out = Selection()
        for addr, sub in self.children.items():
            sub_mask = mask.search(addr)
            if sub_mask is None:
                out.visit(addr)
            elif not sub.is_leaf() and not sub_mask.is_leaf():
                sub_comp = sub.complement(sub_mask)
                if not sub_comp.is_leaf():
                    out.insert(addr, sub_comp)
        return out

    def __iter__(self):
        return iter(self.children.items())

    def __contains__(self, addr):
        return self.search(addr) is not None

    def __eq__(self, other):
        return isinstance(other, Selection) and self.children == other.children

    def __hash__(self):
        return hash(tuple(sorted((k, hash(v)) for k, v in self.children.items())))

    def __repr__(self):
        if self.is_leaf():
            return "Selection(<leaf>)"
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in sorted(self.children.items()))
        return f"Selection({{{inner}}})"

    def leaf_addresses(self, prefix=""):
        """All maximal addresses in this selection, joined with ' / '."""
        out = []
        for addr, sub in sorted(self.children.items()):
            path = addr if not prefix else f"{prefix} / {addr}"
            if sub.is_leaf():
                out.append(path)
            else:
                out.extend(sub.leaf_addresses(path))
        return out


def select(*addrs):
    """Convenience constructor: select(*addresses) -> Selection."""
    return Selection(addrs)
