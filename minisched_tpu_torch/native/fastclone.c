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
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

/* Registered dataclass types (borrowed refs owned by the set below). */
static PyObject *registered = NULL;  /* a Python set of type objects */

static PyObject *clone_obj(PyObject *v);

static PyObject *
clone_dict(PyObject *v)
{
    PyObject *out = PyDict_New();
    if (!out) return NULL;
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
        PyObject *cv = clone_obj(val);
        if (!cv || PyDict_SetItem(out, key, cv) < 0) {
            Py_XDECREF(cv);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(cv);
    }
    return out;
}

static PyObject *
clone_list(PyObject *v)
{
    Py_ssize_t n = PyList_GET_SIZE(v);
    PyObject *out = PyList_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *cv = clone_obj(PyList_GET_ITEM(v, i));
        if (!cv) { Py_DECREF(out); return NULL; }
        PyList_SET_ITEM(out, i, cv);  /* steals */
    }
    return out;
}

static PyObject *
clone_tuple(PyObject *v)
{
    Py_ssize_t n = PyTuple_GET_SIZE(v);
    PyObject *out = PyTuple_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *cv = clone_obj(PyTuple_GET_ITEM(v, i));
        if (!cv) { Py_DECREF(out); return NULL; }
        PyTuple_SET_ITEM(out, i, cv);  /* steals */
    }
    return out;
}

static PyObject *
clone_instance(PyObject *v)
{
    PyTypeObject *tp = Py_TYPE(v);
    /* dict BEFORE allocating the new object: a missing __dict__ is the
     * unsupported-type signal (slots-only class). */
    PyObject *src_dict = PyObject_GetAttrString(v, "__dict__");
    if (!src_dict) return NULL;
    if (!PyDict_Check(src_dict)) {
        Py_DECREF(src_dict);
        PyErr_Format(PyExc_TypeError,
                     "fastclone: %s.__dict__ is not a dict", tp->tp_name);
        return NULL;
    }
    PyObject *new_dict = clone_dict(src_dict);
    Py_DECREF(src_dict);
    if (!new_dict) return NULL;

    /* cls.__new__(cls) without running __init__ — same construction the
     * Python walk uses (object.__new__ for plain dataclasses). */
    PyObject *out = tp->tp_alloc(tp, 0);
    if (!out) { Py_DECREF(new_dict); return NULL; }
    if (PyObject_SetAttrString(out, "__dict__", new_dict) < 0) {
        Py_DECREF(new_dict);
        Py_DECREF(out);
        return NULL;
    }
    Py_DECREF(new_dict);
    return out;
}

static PyObject *clone_obj_inner(PyObject *v);

static PyObject *
clone_obj(PyObject *v)
{
    /* Mirror the Python walk's failure mode on pathological nesting:
     * a catchable RecursionError, never a C-stack segfault. */
    if (Py_EnterRecursiveCall(" in fastclone")) return NULL;
    PyObject *r = clone_obj_inner(v);
    Py_LeaveRecursiveCall();
    return r;
}

static PyObject *
clone_obj_inner(PyObject *v)
{
    PyTypeObject *tp = Py_TYPE(v);
    /* Exact-type checks mirror the Python walk's `t is dict` etc. —
     * subclasses fall through to the registered-instance / error path. */
    if (v == Py_None || tp == &PyUnicode_Type || tp == &PyLong_Type
        || tp == &PyFloat_Type || tp == &PyBool_Type) {
        Py_INCREF(v);
        return v;
    }
    if (tp == &PyDict_Type) return clone_dict(v);
    if (tp == &PyList_Type) return clone_list(v);
    if (tp == &PyTuple_Type) return clone_tuple(v);
    if (tp == &PySet_Type) {
        /* sets here only ever hold scalars (plugin names) — share them */
        return PySet_New(v);
    }
    int reg = PySet_Contains(registered, (PyObject *)tp);
    if (reg < 0) return NULL;
    if (reg) return clone_instance(v);
    PyErr_Format(PyExc_TypeError,
                 "fastclone: unregistered type %s", tp->tp_name);
    return NULL;
}

static PyObject *
py_clone(PyObject *self, PyObject *arg)
{
    return clone_obj(arg);
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
    return PyModule_Create(&moduledef);
}
