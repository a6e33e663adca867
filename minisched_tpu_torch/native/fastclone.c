/* fastclone — native structural clone for the API object tree.
 *
 * The store isolates every create/update/get behind a deep copy of a
 * pure-Python dataclass tree (state/objects.py::deepcopy_obj).  That walk
 * is the single largest host cost of bulk ingestion (a 10k-pod
 * create_many is ~300k recursive _clone calls) and sits on the engine's
 * create-to-bound critical path.  This module is the same recursion in C:
 * the per-node interpreter overhead (frame push, LOAD_GLOBAL, type
 * dispatch) disappears while the semantics stay identical to the Python
 * walk — tests/test_torch_native.py asserts equivalence over the whole
 * object-tree shape space.  A failed build raises; only
 * MINISCHED_NO_NATIVE=1 selects the Python walk.
 *
 * Parity note: the reference's entire runtime is compiled (Go); this is
 * the rebuild's native runtime primitive for the store/ingestion layer,
 * built on demand by minisched_tpu_torch/native/__init__.py with plain g++/cc
 * (no pybind11 dependency — CPython C API only).
 *
 * Semantics (mirrors state/objects.py::_clone):
 *   - str/int/float/bool/None are shared (immutable);
 *   - dict/list/tuple/set rebuild with cloned elements (set elements are
 *     scalars by contract and are shared);
 *   - instances of REGISTERED classes (the dataclass tree) rebuild via
 *     cls.__new__(cls) + a cloned __dict__;
 *   - anything else raises TypeError — the Python caller catches it and
 *     clones that object with the Python walk (an unregistered type).
 *
 * The store's copies (clone_snapshot, untrack): every object the store
 * keeps is immutable and acyclic by its copy discipline (state/store.py:
 * stored objects are replacement-only), so the cycle collector has
 * nothing to find in it. clone_snapshot builds the same copy as clone and
 * takes every container it built (instance, instance __dict__, dict,
 * list, tuple, set) off the collector's lists; untrack does the same for
 * a tree built in Python. Such objects are still freed by their reference
 * counts. clone's copies belong to callers, who mutate them, and stay
 * tracked.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

/* Registered dataclass types (borrowed refs owned by the set below). */
static PyObject *registered = NULL;  /* a Python set of type objects */
static PyObject *str_dict = NULL;    /* the interned name "__dict__" */

/* `keep` is true for the store's copies: each container is taken off the
 * collector's lists once it is filled (a dict is tracked again by the
 * interpreter when a container is inserted into it, so never before). */
static PyObject *clone_obj(PyObject *v, int keep);

static PyObject *
clone_dict(PyObject *v, int keep)
{
    PyObject *out = PyDict_New();
    if (!out) return NULL;
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
        PyObject *cv = clone_obj(val, keep);
        if (!cv || PyDict_SetItem(out, key, cv) < 0) {
            Py_XDECREF(cv);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(cv);
    }
    if (keep) PyObject_GC_UnTrack(out);
    return out;
}

static PyObject *
clone_list(PyObject *v, int keep)
{
    Py_ssize_t n = PyList_GET_SIZE(v);
    PyObject *out = PyList_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *cv = clone_obj(PyList_GET_ITEM(v, i), keep);
        if (!cv) { Py_DECREF(out); return NULL; }
        PyList_SET_ITEM(out, i, cv);  /* steals */
    }
    if (keep) PyObject_GC_UnTrack(out);
    return out;
}

static PyObject *
clone_tuple(PyObject *v, int keep)
{
    Py_ssize_t n = PyTuple_GET_SIZE(v);
    PyObject *out = PyTuple_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *cv = clone_obj(PyTuple_GET_ITEM(v, i), keep);
        if (!cv) { Py_DECREF(out); return NULL; }
        PyTuple_SET_ITEM(out, i, cv);  /* steals */
    }
    if (keep) PyObject_GC_UnTrack(out);
    return out;
}

static PyObject *
clone_instance(PyObject *v, int keep)
{
    PyTypeObject *tp = Py_TYPE(v);
    /* dict BEFORE allocating the new object: a missing __dict__ is the
     * unsupported-type signal (slots-only class). */
    PyObject *src_dict = PyObject_GetAttr(v, str_dict);
    if (!src_dict) return NULL;
    if (!PyDict_Check(src_dict)) {
        Py_DECREF(src_dict);
        PyErr_Format(PyExc_TypeError,
                     "fastclone: %s.__dict__ is not a dict", tp->tp_name);
        return NULL;
    }
    PyObject *new_dict = clone_dict(src_dict, keep);
    Py_DECREF(src_dict);
    if (!new_dict) return NULL;

    /* cls.__new__(cls) without running __init__ — same construction the
     * Python walk uses (object.__new__ for plain dataclasses). */
    PyObject *out = tp->tp_alloc(tp, 0);
    if (!out) { Py_DECREF(new_dict); return NULL; }
    if (PyObject_SetAttr(out, str_dict, new_dict) < 0) {
        Py_DECREF(new_dict);
        Py_DECREF(out);
        return NULL;
    }
    Py_DECREF(new_dict);
    if (keep) PyObject_GC_UnTrack(out);
    return out;
}

static PyObject *clone_obj_inner(PyObject *v, int keep);

static PyObject *
clone_obj(PyObject *v, int keep)
{
    /* Mirror the Python walk's failure mode on pathological nesting:
     * a catchable RecursionError, never a C-stack segfault. */
    if (Py_EnterRecursiveCall(" in fastclone")) return NULL;
    PyObject *r = clone_obj_inner(v, keep);
    Py_LeaveRecursiveCall();
    return r;
}

static PyObject *
clone_obj_inner(PyObject *v, int keep)
{
    PyTypeObject *tp = Py_TYPE(v);
    /* Exact-type checks mirror the Python walk's `t is dict` etc. —
     * subclasses fall through to the registered-instance / error path. */
    if (v == Py_None || tp == &PyUnicode_Type || tp == &PyLong_Type
        || tp == &PyFloat_Type || tp == &PyBool_Type) {
        Py_INCREF(v);
        return v;
    }
    if (tp == &PyDict_Type) return clone_dict(v, keep);
    if (tp == &PyList_Type) return clone_list(v, keep);
    if (tp == &PyTuple_Type) return clone_tuple(v, keep);
    if (tp == &PySet_Type) {
        /* sets here only ever hold scalars (plugin names) — share them */
        PyObject *out = PySet_New(v);
        if (out && keep) PyObject_GC_UnTrack(out);
        return out;
    }
    int reg = PySet_Contains(registered, (PyObject *)tp);
    if (reg < 0) return NULL;
    if (reg) return clone_instance(v, keep);
    PyErr_Format(PyExc_TypeError,
                 "fastclone: unregistered type %s", tp->tp_name);
    return NULL;
}

/* untrack: take a tree built in Python off the collector's lists. Only
 * containers still tracked are untracked and descended into: a container
 * off the lists holds nothing tracked (this walk untracked its subtree,
 * or the interpreter found it holding only atoms), so structure a new
 * version shares with the one it supersedes is not walked again. Dicts,
 * lists, tuples (and tuple subclasses without an instance dict, such as
 * named tuples) and registered instances with their __dict__ are
 * untracked; an object of any other type is left tracked and not
 * descended into. Returns 0, or -1 with an exception set. */
static int untrack_obj(PyObject *v);

static int
untrack_dict(PyObject *d)
{
    Py_ssize_t pos = 0;
    PyObject *key, *val;
    PyObject_GC_UnTrack(d);
    while (PyDict_Next(d, &pos, &key, &val)) {
        if (untrack_obj(key) < 0 || untrack_obj(val) < 0) return -1;
    }
    return 0;
}

static int
untrack_inner(PyObject *v)
{
    PyTypeObject *tp = Py_TYPE(v);
    if (tp == &PyDict_Type) return untrack_dict(v);
    if (tp == &PyList_Type || (PyTuple_Check(v) && (
            tp == &PyTuple_Type || tp->tp_dictoffset == 0))) {
        PyObject_GC_UnTrack(v);
        for (Py_ssize_t i = 0; i < Py_SIZE(v); i++) {
            if (untrack_obj(tp == &PyList_Type ? PyList_GET_ITEM(v, i)
                                               : PyTuple_GET_ITEM(v, i)) < 0)
                return -1;
        }
        return 0;
    }
    int reg = PySet_Contains(registered, (PyObject *)tp);
    if (reg <= 0) return reg;  /* -1: error; 0: another type, left as is */
    PyObject *d = PyObject_GetAttr(v, str_dict);
    if (!d) return -1;
    PyObject_GC_UnTrack(v);
    int r = 0;
    if (PyDict_CheckExact(d) && PyObject_GC_IsTracked(d)) r = untrack_dict(d);
    Py_DECREF(d);
    return r;
}

static int
untrack_obj(PyObject *v)
{
    if (!PyObject_IS_GC(v) || !PyObject_GC_IsTracked(v)) return 0;
    if (Py_EnterRecursiveCall(" in fastclone.untrack")) return -1;
    int r = untrack_inner(v);
    Py_LeaveRecursiveCall();
    return r;
}

static PyObject *
py_clone(PyObject *self, PyObject *arg)
{
    return clone_obj(arg, 0);
}

static PyObject *
py_clone_snapshot(PyObject *self, PyObject *arg)
{
    return clone_obj(arg, 1);
}

static PyObject *
py_untrack(PyObject *self, PyObject *arg)
{
    if (untrack_obj(arg) < 0) return NULL;
    Py_RETURN_NONE;
}

static PyObject *
py_register(PyObject *self, PyObject *arg)
{
    if (!PyType_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "register() expects a class");
        return NULL;
    }
    if (PySet_Add(registered, arg) < 0) return NULL;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"clone", py_clone, METH_O,
     "Structural clone of a registered-dataclass tree."},
    {"clone_snapshot", py_clone_snapshot, METH_O,
     "clone, with every container built taken off the collector's "
     "lists: for the store's immutable, acyclic copies."},
    {"untrack", py_untrack, METH_O,
     "Take a tree built in Python off the collector's lists (containers "
     "still tracked only)."},
    {"register", py_register, METH_O,
     "Register a class whose instances clone via __dict__ rebuild."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastclone",
    "Native structural clone for the API object tree.", -1, methods,
};

PyMODINIT_FUNC
PyInit__fastclone(void)
{
    registered = PySet_New(NULL);
    if (!registered) return NULL;
    str_dict = PyUnicode_InternFromString("__dict__");
    if (!str_dict) return NULL;
    return PyModule_Create(&moduledef);
}
