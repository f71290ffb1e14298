/* _ctrie: native choice-map (trie) core for the eager interpreter.
 *
 * The reference's choice maps are compiled Rust (modppl/src/trie.rs:7-247:
 * HashMap children + Option value + weight bookkeeping). The JAX build's
 * compiled tier stages tries into XLA programs, but the *eager* tier — the
 * semantic reference implementation that also runs dynamic-structure and
 * trans-dimensional models — walks tries in the Python interpreter on every
 * sample site. This extension moves the hot node type and its walk/mutate
 * methods to C: CTrieBase holds (children dict, value, logp, dist) at
 * C-struct offsets and implements search/read/observe/w_observe/insert/
 * remove/weight plus the inner-value ops without interpreter dispatch.
 *
 * The Python class `Trie` (modppl_tpu/core/trie.py) subclasses CTrieBase,
 * keeping the long-tail methods (merge/schema/collect/eq/pytree flatten) in
 * Python; tests/test_native_trie.py runs the full trie battery against both
 * the native-backed and the pure-Python base to assert exact parity.
 *
 * Configuration from Python at import (core/trie.py):
 *   _ctrie.configure(empty_sentinel, components_fn, sum_logp_fn)
 * - empty_sentinel: the object meaning "no inner value" (trie.py _EMPTY)
 * - components_fn(addr) -> tuple of path components (memoized; native
 *   _addrops.lookup-backed)
 * - sum_logp_fn(logp) -> reduce a leaf logp over its local axes
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *EMPTY = NULL;        /* sentinel: no inner value */
static PyObject *components_fn = NULL;
static PyObject *sum_logp_fn = NULL;

typedef struct {
    PyObject_HEAD
    PyObject *children; /* dict: component -> CTrieBase */
    PyObject *value;    /* inner value; EMPTY sentinel when absent */
    PyObject *logp;     /* leaf log-probability (float or jnp array) */
    PyObject *dist;     /* Distribution metadata or None */
} CTrie;

static PyTypeObject CTrieType; /* forward */

static int ensure_configured(void)
{
    if (!EMPTY || !components_fn || !sum_logp_fn) {
        PyErr_SetString(PyExc_RuntimeError,
                        "_ctrie: module not configured (import through "
                        "modppl_tpu.core.trie)");
        return -1;
    }
    return 0;
}

/* ---- lifecycle -------------------------------------------------------- */

static PyObject *ctrie_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    CTrie *self = (CTrie *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    self->children = PyDict_New();
    if (!self->children) {
        Py_DECREF(self);
        return NULL;
    }
    if (ensure_configured() < 0) {
        Py_DECREF(self);
        return NULL;
    }
    Py_INCREF(EMPTY);
    self->value = EMPTY;
    self->logp = PyFloat_FromDouble(0.0);
    Py_INCREF(Py_None);
    self->dist = Py_None;
    return (PyObject *)self;
}

static int ctrie_traverse(PyObject *op, visitproc visit, void *arg)
{
    CTrie *self = (CTrie *)op;
    Py_VISIT(self->children);
    Py_VISIT(self->value);
    Py_VISIT(self->logp);
    Py_VISIT(self->dist);
    return 0;
}

static int ctrie_clear(PyObject *op)
{
    CTrie *self = (CTrie *)op;
    Py_CLEAR(self->children);
    Py_CLEAR(self->value);
    Py_CLEAR(self->logp);
    Py_CLEAR(self->dist);
    return 0;
}

static void ctrie_dealloc(PyObject *op)
{
    PyObject_GC_UnTrack(op);
    ctrie_clear(op);
    Py_TYPE(op)->tp_free(op);
}

/* ---- helpers ---------------------------------------------------------- */

static PyObject *get_components(PyObject *addr)
{
    return PyObject_CallFunctionObjArgs(components_fn, addr, NULL);
}

/* borrowed-ref walk to the node at comps[0..n); NULL (no error) if absent */
static CTrie *walk(CTrie *node, PyObject *comps, Py_ssize_t n)
{
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *c = PyTuple_GET_ITEM(comps, i);
        PyObject *child = PyDict_GetItemWithError(node->children, c);
        if (!child)
            return NULL; /* PyErr may be set by GetItemWithError */
        node = (CTrie *)child;
    }
    return node;
}

/* walk to comps[0..n) creating missing intermediates (like setdefault);
 * returns borrowed ref or NULL on error */
static CTrie *walk_create(CTrie *node, PyObject *comps, Py_ssize_t n)
{
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *c = PyTuple_GET_ITEM(comps, i);
        PyObject *child = PyDict_GetItemWithError(node->children, c);
        if (!child) {
            if (PyErr_Occurred())
                return NULL;
            child = ctrie_new(Py_TYPE((PyObject *)node), NULL, NULL);
            if (!child)
                return NULL;
            if (PyDict_SetItem(node->children, c, child) < 0) {
                Py_DECREF(child);
                return NULL;
            }
            Py_DECREF(child); /* dict holds it */
        }
        node = (CTrie *)child;
    }
    return node;
}

static int is_empty_node(CTrie *t)
{
    return PyDict_GET_SIZE(t->children) == 0 && t->value == EMPTY;
}

/* ---- methods ---------------------------------------------------------- */

static PyObject *ctrie_is_empty(PyObject *op, PyObject *noargs)
{
    return PyBool_FromLong(is_empty_node((CTrie *)op));
}

static PyObject *ctrie_is_leaf(PyObject *op, PyObject *noargs)
{
    CTrie *t = (CTrie *)op;
    return PyBool_FromLong(PyDict_GET_SIZE(t->children) == 0 &&
                           t->value != EMPTY);
}

static PyObject *ctrie_has_inner(PyObject *op, PyObject *noargs)
{
    return PyBool_FromLong(((CTrie *)op)->value != EMPTY);
}

static PyObject *ctrie_inner(PyObject *op, PyObject *noargs)
{
    CTrie *t = (CTrie *)op;
    PyObject *v = (t->value == EMPTY) ? Py_None : t->value;
    Py_INCREF(v);
    return v;
}

static PyObject *ctrie_take_inner(PyObject *op, PyObject *noargs)
{
    CTrie *t = (CTrie *)op;
    PyObject *v = (t->value == EMPTY) ? Py_None : t->value;
    Py_INCREF(v);
    Py_INCREF(EMPTY);
    Py_SETREF(t->value, EMPTY);
    return v;
}

static PyObject *ctrie_replace_inner(PyObject *op, PyObject *value)
{
    CTrie *t = (CTrie *)op;
    PyObject *prev = (t->value == EMPTY) ? Py_None : t->value;
    Py_INCREF(prev);
    Py_INCREF(value);
    Py_SETREF(t->value, value);
    return prev;
}

static PyObject *ctrie_expect_inner(PyObject *op, PyObject *msg)
{
    CTrie *t = (CTrie *)op;
    if (t->value == EMPTY) {
        PyErr_SetObject(PyExc_KeyError, msg);
        return NULL;
    }
    Py_INCREF(t->value);
    return t->value;
}

static PyObject *ctrie_search(PyObject *op, PyObject *addr)
{
    if (ensure_configured() < 0)
        return NULL;
    PyObject *comps = get_components(addr);
    if (!comps)
        return NULL;
    CTrie *node = walk((CTrie *)op, comps, PyTuple_GET_SIZE(comps));
    Py_DECREF(comps);
    if (!node) {
        if (PyErr_Occurred())
            return NULL;
        Py_RETURN_NONE;
    }
    Py_INCREF((PyObject *)node);
    return (PyObject *)node;
}

static PyObject *ctrie_read(PyObject *op, PyObject *addr)
{
    if (ensure_configured() < 0)
        return NULL;
    PyObject *comps = get_components(addr);
    if (!comps)
        return NULL;
    CTrie *node = walk((CTrie *)op, comps, PyTuple_GET_SIZE(comps));
    Py_DECREF(comps);
    if (!node) {
        if (PyErr_Occurred())
            return NULL;
        PyErr_Format(PyExc_KeyError,
                     "read: failed when searching empty address \"%U\"", addr);
        return NULL;
    }
    if (node->value == EMPTY) {
        PyErr_Format(PyExc_KeyError,
                     "read: no value found at address \"%U\"", addr);
        return NULL;
    }
    Py_INCREF(node->value);
    return node->value;
}

static PyObject *ctrie_w_observe(PyObject *op, PyObject *args)
{
    PyObject *addr, *value, *logp, *dist = Py_None;
    if (!PyArg_ParseTuple(args, "OOO|O", &addr, &value, &logp, &dist))
        return NULL;
    if (ensure_configured() < 0)
        return NULL;
    PyObject *comps = get_components(addr);
    if (!comps)
        return NULL;
    Py_ssize_t n = PyTuple_GET_SIZE(comps);
    CTrie *parent = walk_create((CTrie *)op, comps, n - 1);
    if (!parent) {
        Py_DECREF(comps);
        return NULL;
    }
    PyObject *last = PyTuple_GET_ITEM(comps, n - 1);
    PyObject *existing = PyDict_GetItemWithError(parent->children, last);
    if (existing || PyErr_Occurred()) {
        if (existing)
            PyErr_Format(PyExc_KeyError,
                         "w_observe: attempted to put into occupied address "
                         "\"%U\"", last);
        Py_DECREF(comps);
        return NULL;
    }
    CTrie *leaf = (CTrie *)ctrie_new(Py_TYPE(op), NULL, NULL);
    if (!leaf) {
        Py_DECREF(comps);
        return NULL;
    }
    Py_INCREF(value);
    Py_SETREF(leaf->value, value);
    Py_INCREF(logp);
    Py_SETREF(leaf->logp, logp);
    Py_INCREF(dist);
    Py_SETREF(leaf->dist, dist);
    int rc = PyDict_SetItem(parent->children, last, (PyObject *)leaf);
    Py_DECREF(leaf);
    Py_DECREF(comps);
    if (rc < 0)
        return NULL;
    Py_RETURN_NONE;
}

static PyObject *ctrie_insert(PyObject *op, PyObject *args)
{
    PyObject *addr, *sub;
    if (!PyArg_ParseTuple(args, "OO", &addr, &sub))
        return NULL;
    if (ensure_configured() < 0)
        return NULL;
    PyObject *comps = get_components(addr);
    if (!comps)
        return NULL;
    Py_ssize_t n = PyTuple_GET_SIZE(comps);
    CTrie *parent = walk_create((CTrie *)op, comps, n - 1);
    if (!parent) {
        Py_DECREF(comps);
        return NULL;
    }
    PyObject *last = PyTuple_GET_ITEM(comps, n - 1);
    PyObject *existing = PyDict_GetItemWithError(parent->children, last);
    if (existing || PyErr_Occurred()) {
        if (existing)
            PyErr_Format(PyExc_KeyError,
                         "insert: attempted to put into occupied address "
                         "\"%U\"", last);
        Py_DECREF(comps);
        return NULL;
    }
    int rc = PyDict_SetItem(parent->children, last, sub);
    Py_DECREF(comps);
    if (rc < 0)
        return NULL;
    Py_RETURN_NONE;
}

static PyObject *ctrie_remove(PyObject *op, PyObject *addr)
{
    if (ensure_configured() < 0)
        return NULL;
    PyObject *comps = get_components(addr);
    if (!comps)
        return NULL;
    Py_ssize_t n = PyTuple_GET_SIZE(comps);

    /* record the path so empty intermediates can be pruned, as in the
     * reference (trie.rs:162-183) / the Python fallback */
    CTrie *node = (CTrie *)op;
    CTrie **path = PyMem_New(CTrie *, (size_t)n);
    if (!path) {
        Py_DECREF(comps);
        return PyErr_NoMemory();
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        path[i] = node;
        PyObject *child =
            PyDict_GetItemWithError(node->children,
                                    PyTuple_GET_ITEM(comps, i));
        if (!child) {
            PyMem_Free(path);
            Py_DECREF(comps);
            if (PyErr_Occurred())
                return NULL;
            Py_RETURN_NONE;
        }
        node = (CTrie *)child;
    }
    Py_INCREF((PyObject *)node); /* keep the removed subtree alive */
    if (PyDict_DelItem(path[n - 1]->children,
                       PyTuple_GET_ITEM(comps, n - 1)) < 0) {
        Py_DECREF((PyObject *)node);
        PyMem_Free(path);
        Py_DECREF(comps);
        return NULL;
    }
    for (Py_ssize_t i = n - 1; i > 0; i--) {
        if (!is_empty_node(path[i]))
            break;
        if (PyDict_DelItem(path[i - 1]->children,
                           PyTuple_GET_ITEM(comps, i - 1)) < 0) {
            Py_DECREF((PyObject *)node);
            PyMem_Free(path);
            Py_DECREF(comps);
            return NULL;
        }
    }
    PyMem_Free(path);
    Py_DECREF(comps);
    return (PyObject *)node;
}

static PyObject *weight_rec(CTrie *t)
{
    PyObject *acc =
        PyObject_CallFunctionObjArgs(sum_logp_fn, t->logp, NULL);
    if (!acc)
        return NULL;
    PyObject *key, *child;
    Py_ssize_t pos = 0;
    while (PyDict_Next(t->children, &pos, &key, &child)) {
        PyObject *w = weight_rec((CTrie *)child);
        if (!w) {
            Py_DECREF(acc);
            return NULL;
        }
        PyObject *sum = PyNumber_Add(acc, w);
        Py_DECREF(acc);
        Py_DECREF(w);
        if (!sum)
            return NULL;
        acc = sum;
    }
    return acc;
}

static PyObject *ctrie_weight(PyObject *op, PyObject *noargs)
{
    if (ensure_configured() < 0)
        return NULL;
    return weight_rec((CTrie *)op);
}

static PyObject *ctrie_contains(PyObject *op, PyObject *addr)
{
    PyObject *node = ctrie_search(op, addr);
    if (!node)
        return NULL;
    PyObject *r = PyBool_FromLong(node != Py_None);
    Py_DECREF(node);
    return r;
}

static Py_ssize_t ctrie_len(PyObject *op)
{
    return PyDict_GET_SIZE(((CTrie *)op)->children);
}

/* ---- attribute access -------------------------------------------------- */

static PyObject *get_children(PyObject *op, void *closure)
{
    CTrie *t = (CTrie *)op;
    Py_INCREF(t->children);
    return t->children;
}

static int set_children(PyObject *op, PyObject *v, void *closure)
{
    if (!v || !PyDict_Check(v)) {
        PyErr_SetString(PyExc_TypeError, "children must be a dict");
        return -1;
    }
    Py_INCREF(v);
    Py_SETREF(((CTrie *)op)->children, v);
    return 0;
}

#define FIELD_GETSET(NAME)                                                  \
    static PyObject *get_##NAME(PyObject *op, void *closure)                \
    {                                                                       \
        CTrie *t = (CTrie *)op;                                             \
        Py_INCREF(t->NAME);                                                 \
        return t->NAME;                                                     \
    }                                                                       \
    static int set_##NAME(PyObject *op, PyObject *v, void *closure)         \
    {                                                                       \
        if (!v) {                                                           \
            PyErr_SetString(PyExc_TypeError, #NAME " cannot be deleted");   \
            return -1;                                                      \
        }                                                                   \
        Py_INCREF(v);                                                       \
        Py_SETREF(((CTrie *)op)->NAME, v);                                  \
        return 0;                                                           \
    }

FIELD_GETSET(value)
FIELD_GETSET(logp)
FIELD_GETSET(dist)

static PyGetSetDef ctrie_getset[] = {
    {"children", get_children, set_children, "component -> subtrie dict", NULL},
    {"value", get_value, set_value, "inner value (sentinel when absent)", NULL},
    {"logp", get_logp, set_logp, "leaf log-probability", NULL},
    {"dist", get_dist, set_dist, "sampling Distribution metadata", NULL},
    {NULL},
};

static PyMethodDef ctrie_methods[] = {
    {"is_empty", ctrie_is_empty, METH_NOARGS,
     "No inner value and no descendants (trie.rs:36-38)."},
    {"is_leaf", ctrie_is_leaf, METH_NOARGS,
     "Inner value but no descendants (trie.rs:41-43)."},
    {"has_inner", ctrie_has_inner, METH_NOARGS, NULL},
    {"inner", ctrie_inner, METH_NOARGS,
     "Inner value or None (trie.rs:50-52)."},
    {"take_inner", ctrie_take_inner, METH_NOARGS,
     "Remove and return the inner value, or None (trie.rs:55-57)."},
    {"replace_inner", ctrie_replace_inner, METH_O,
     "Set the inner value, returning the previous or None (trie.rs:60-62)."},
    {"expect_inner", ctrie_expect_inner, METH_O, NULL},
    {"search", ctrie_search, METH_O,
     "Descendant node at addr, or None (trie.rs:90-101)."},
    {"read", ctrie_read, METH_O,
     "Inner value at addr; raises KeyError when missing (dyngenfn.rs:17-35)."},
    {"w_observe", ctrie_w_observe, METH_VARARGS,
     "Store a weighted value leaf; KeyError if occupied (trie.rs:122-138)."},
    {"insert", ctrie_insert, METH_VARARGS,
     "Insert a subtrie; KeyError if occupied (trie.rs:141-159)."},
    {"remove", ctrie_remove, METH_O,
     "Remove and return the subtrie at addr, or None (trie.rs:162-183)."},
    {"weight", ctrie_weight, METH_NOARGS,
     "Sum of all leaf logps below this node (trie.rs:85-87)."},
    {"_contains_addr", ctrie_contains, METH_O, NULL},
    {NULL},
};

static PySequenceMethods ctrie_as_sequence = {
    .sq_length = ctrie_len,
};

static PyTypeObject CTrieType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "modppl_tpu.native._ctrie.CTrieBase",
    .tp_basicsize = sizeof(CTrie),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE | Py_TPFLAGS_HAVE_GC,
    .tp_doc = "Native trie node: children dict + inner value + leaf logp.",
    .tp_new = ctrie_new,
    .tp_dealloc = ctrie_dealloc,
    .tp_traverse = ctrie_traverse,
    .tp_clear = ctrie_clear,
    .tp_methods = ctrie_methods,
    .tp_getset = ctrie_getset,
    .tp_as_sequence = &ctrie_as_sequence,
};

/* ---- module ------------------------------------------------------------ */

static PyObject *mod_configure(PyObject *self, PyObject *args)
{
    PyObject *sentinel, *comps, *sumfn;
    if (!PyArg_ParseTuple(args, "OOO", &sentinel, &comps, &sumfn))
        return NULL;
    Py_INCREF(sentinel);
    Py_XSETREF(EMPTY, sentinel);
    Py_INCREF(comps);
    Py_XSETREF(components_fn, comps);
    Py_INCREF(sumfn);
    Py_XSETREF(sum_logp_fn, sumfn);
    Py_RETURN_NONE;
}

static PyMethodDef mod_methods[] = {
    {"configure", mod_configure, METH_VARARGS,
     "configure(empty_sentinel, components_fn, sum_logp_fn)"},
    {NULL},
};

static struct PyModuleDef ctrie_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "_ctrie",
    .m_doc = "Native choice-map (trie) core.",
    .m_size = -1,
    .m_methods = mod_methods,
};

PyMODINIT_FUNC PyInit__ctrie(void)
{
    PyObject *m;
    if (PyType_Ready(&CTrieType) < 0)
        return NULL;
    m = PyModule_Create(&ctrie_module);
    if (!m)
        return NULL;
    Py_INCREF(&CTrieType);
    if (PyModule_AddObject(m, "CTrieBase", (PyObject *)&CTrieType) < 0) {
        Py_DECREF(&CTrieType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
