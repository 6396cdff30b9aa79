/* Fast path for the per-binding encode loop (ops/tensors.encode_batch).
 *
 * The Python loop costs ~7us per binding after caching; this extension
 * walks the same (spec, status) objects through the CPython C API at
 * ~1us per binding for the COMMON shape:
 *
 *   - placement is spec.placement, already registered (identity-keyed);
 *   - GVK and request-class already in the call's vocabulary dicts;
 *   - no components, no previous assignment, no eviction tasks;
 *   - no ClusterAffinities needing per-binding resolution.
 *
 * Anything else goes through `miss_cb(b)` — the Python slow path for that
 * single binding (which also registers new vocabulary entries so later
 * bindings hit). Behavior is defined by ONE implementation: the Python
 * loop (encode_batch(native=False)); tests/test_torch_native_encode.py
 * asserts the fast path produces identical tensors.  The port's copy of the
 * JAX package's native/encode_fast.c, unchanged but for comments: the
 * port's models carry the same attribute names.
 *
 * Build: gcc -O2 -shared -fPIC -I<python-include> (native/__init__.py, at
 * first use).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

/* interned attribute names, set up in module init */
static PyObject *s_placement, *s_resource, *s_api_version, *s_kind, *s_uid;
static PyObject *s_replicas, *s_replica_requirements, *s_resource_request;
static PyObject *s_milli, *s_components, *s_clusters, *s_gets, *s_reschedule;
static PyObject *s_cluster_affinity, *s_cluster_affinities;

static uint32_t fnv32a(const char *data, Py_ssize_t len) {
  uint32_t h = 0x811C9DC5u;
  for (Py_ssize_t i = 0; i < len; i++) {
    h ^= (unsigned char)data[i];
    h *= 0x01000193u;
  }
  return h;
}

/* Returns a BORROWED int value from a dict lookup of an owned key; -1 if
 * absent. Steals nothing. */
static long dict_lookup_long(PyObject *dict, PyObject *key) {
  PyObject *v = PyDict_GetItem(dict, key); /* borrowed */
  if (v == NULL) return -1;
  return PyLong_AsLong(v);
}

/* encode_fast(items, pid_route_by_id, gvk_ids, class_ids,
 *             placement_id, gvk_id, class_id, replicas, uid_desc, fresh,
 *             non_workload, nw_shortcut, route, miss_cb)
 *
 * Array arguments are writable 1-D numpy arrays exposed via the buffer
 * protocol with dtypes int32/int64/bool as noted below.  Returns the
 * number of bindings handled by the fast path.
 */
static PyObject *encode_fast(PyObject *self, PyObject *args) {
  PyObject *items, *pid_route_by_id, *gvk_ids, *class_ids, *miss_cb;
  PyObject *a_pid, *a_gvk, *a_cls, *a_rep, *a_uid, *a_fresh, *a_nw, *a_nws,
      *a_route;
  long replica_cap = 0;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOlO", &items, &pid_route_by_id,
                        &gvk_ids, &class_ids, &a_pid, &a_gvk, &a_cls, &a_rep,
                        &a_uid, &a_fresh, &a_nw, &a_nws, &a_route,
                        &replica_cap, &miss_cb))
    return NULL;

  Py_buffer b_pid, b_gvk, b_cls, b_rep, b_uid, b_fresh, b_nw, b_nws, b_route;
  memset(&b_pid, 0, sizeof(b_pid));
  if (PyObject_GetBuffer(a_pid, &b_pid, PyBUF_WRITABLE) < 0) return NULL;
  if (PyObject_GetBuffer(a_gvk, &b_gvk, PyBUF_WRITABLE) < 0) goto fail1;
  if (PyObject_GetBuffer(a_cls, &b_cls, PyBUF_WRITABLE) < 0) goto fail2;
  if (PyObject_GetBuffer(a_rep, &b_rep, PyBUF_WRITABLE) < 0) goto fail3;
  if (PyObject_GetBuffer(a_uid, &b_uid, PyBUF_WRITABLE) < 0) goto fail4;
  if (PyObject_GetBuffer(a_fresh, &b_fresh, PyBUF_WRITABLE) < 0) goto fail5;
  if (PyObject_GetBuffer(a_nw, &b_nw, PyBUF_WRITABLE) < 0) goto fail6;
  if (PyObject_GetBuffer(a_nws, &b_nws, PyBUF_WRITABLE) < 0) goto fail7;
  if (PyObject_GetBuffer(a_route, &b_route, PyBUF_WRITABLE) < 0) goto fail8;

  int32_t *pid_arr = (int32_t *)b_pid.buf;
  int32_t *gvk_arr = (int32_t *)b_gvk.buf;
  int32_t *cls_arr = (int32_t *)b_cls.buf;
  int64_t *rep_arr = (int64_t *)b_rep.buf;
  uint8_t *uid_arr = (uint8_t *)b_uid.buf;
  uint8_t *fresh_arr = (uint8_t *)b_fresh.buf;
  uint8_t *nw_arr = (uint8_t *)b_nw.buf;
  uint8_t *nws_arr = (uint8_t *)b_nws.buf;
  int32_t *route_arr = (int32_t *)b_route.buf;

  Py_ssize_t n = PySequence_Length(items);
  Py_ssize_t handled = 0;
  PyObject *fast_items = PySequence_Fast(items, "items must be a sequence");
  if (fast_items == NULL) goto fail9;

  for (Py_ssize_t b = 0; b < n; b++) {
    PyObject *pair = PySequence_Fast_GET_ITEM(fast_items, b); /* borrowed */
    if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
      /* list pairs etc. work on the Python path; route them there */
      PyObject *r = PyObject_CallFunction(miss_cb, "n", b);
      if (r == NULL) goto loop_error;
      Py_DECREF(r);
      continue;
    }
    PyObject *spec = PyTuple_GET_ITEM(pair, 0); /* borrowed */

    int slow = 0;
    PyObject *placement = NULL, *resource = NULL, *rr = NULL;

    /* ---- placement: identity-keyed fast lookup ---- */
    placement = PyObject_GetAttr(spec, s_placement);
    if (placement == NULL) goto item_error;
    long pid = -1, route = -1;
    if (placement == Py_None) {
      slow = 1;
    } else {
      /* ClusterAffinities needing resolution -> slow path */
      PyObject *aff = PyObject_GetAttr(placement, s_cluster_affinity);
      if (aff == NULL) goto item_error;
      int aff_none = (aff == Py_None);
      Py_DECREF(aff);
      if (aff_none) {
        PyObject *affs = PyObject_GetAttr(placement, s_cluster_affinities);
        if (affs == NULL) goto item_error;
        Py_ssize_t n_affs = PySequence_Length(affs);
        Py_DECREF(affs);
        if (n_affs != 0) slow = 1;
      }
      if (!slow) {
        PyObject *key = PyLong_FromVoidPtr(placement);
        if (key == NULL) goto item_error;
        PyObject *entry = PyDict_GetItem(pid_route_by_id, key); /* borrowed */
        Py_DECREF(key);
        if (entry == NULL) {
          slow = 1;
        } else {
          /* entry = (placement_obj, pid, route); verify identity so a
           * recycled id() can never alias a dead placement */
          if (PyTuple_GET_ITEM(entry, 0) != placement) {
            slow = 1;
          } else {
            pid = PyLong_AsLong(PyTuple_GET_ITEM(entry, 1));
            route = PyLong_AsLong(PyTuple_GET_ITEM(entry, 2));
          }
        }
      }
    }

    /* ---- components / prev clusters / evictions: any -> slow ---- */
    if (!slow) {
      PyObject *comps = PyObject_GetAttr(spec, s_components);
      if (comps == NULL) goto item_error;
      Py_ssize_t n_comps = PySequence_Length(comps);
      Py_DECREF(comps);
      PyObject *prev = PyObject_GetAttr(spec, s_clusters);
      if (prev == NULL) goto item_error;
      Py_ssize_t n_prev = PySequence_Length(prev);
      Py_DECREF(prev);
      PyObject *gets = PyObject_GetAttr(spec, s_gets);
      if (gets == NULL) goto item_error;
      Py_ssize_t n_gets = PySequence_Length(gets);
      Py_DECREF(gets);
      if (n_comps != 0 || n_prev != 0 || n_gets != 0) slow = 1;
    }

    /* ---- fresh: reschedule_triggered_at must be None for the fast path
     * (a set trigger needs the status comparison -> slow) ---- */
    if (!slow) {
      PyObject *rta = PyObject_GetAttr(spec, s_reschedule);
      if (rta == NULL) goto item_error;
      int rta_none = (rta == Py_None);
      Py_DECREF(rta);
      if (!rta_none) slow = 1;
    }

    /* ---- gvk vocabulary ---- */
    long gid = -1;
    if (!slow) {
      resource = PyObject_GetAttr(spec, s_resource);
      if (resource == NULL) goto item_error;
      PyObject *av = PyObject_GetAttr(resource, s_api_version);
      PyObject *kd = av ? PyObject_GetAttr(resource, s_kind) : NULL;
      if (kd == NULL) {
        Py_XDECREF(av);
        goto item_error;
      }
      PyObject *gkey = PyTuple_Pack(2, av, kd);
      Py_DECREF(av);
      Py_DECREF(kd);
      if (gkey == NULL) goto item_error;
      gid = dict_lookup_long(gvk_ids, gkey);
      Py_DECREF(gkey);
      if (gid < 0) slow = 1;
    }

    /* ---- request class vocabulary ---- */
    long cid = -1;
    long replicas = 0;
    if (!slow) {
      PyObject *rep_obj = PyObject_GetAttr(spec, s_replicas);
      if (rep_obj == NULL) goto item_error;
      int overflow = 0;
      replicas = PyLong_AsLongAndOverflow(rep_obj, &overflow);
      Py_DECREF(rep_obj);
      if (replicas == -1 && !overflow && PyErr_Occurred()) goto item_error;
      /* replica counts beyond the device kernel's cap take the
       * arbitrary-precision host route (ROUTE_HUGE_REPLICAS) — the Python
       * path owns that decision */
      if (overflow || replicas > replica_cap) slow = 1;

      rr = PyObject_GetAttr(spec, s_replica_requirements);
      if (rr == NULL) goto item_error;
      if (rr != Py_None) {
        PyObject *req = PyObject_GetAttr(rr, s_resource_request);
        if (req == NULL) goto item_error;
        int is_dict = PyDict_Check(req);
        if (!is_dict || PyDict_Size(req) == 0) {
          Py_DECREF(req);
          if (!is_dict) slow = 1; /* unusual shape: slow path */
          /* empty request: class stays -1 */
        } else {
          /* build the canonical sorted (name, milli) tuple key */
          Py_ssize_t sz = PyDict_Size(req);
          PyObject *lst = PyList_New(0);
          if (lst == NULL) {
            Py_DECREF(req);
            goto item_error;
          }
          PyObject *k, *v;
          Py_ssize_t pos = 0;
          int ok = 1;
          while (PyDict_Next(req, &pos, &k, &v)) {
            PyObject *milli = PyObject_GetAttr(v, s_milli);
            if (milli == NULL) {
              ok = 0;
              break;
            }
            PyObject *pairk = PyTuple_Pack(2, k, milli);
            Py_DECREF(milli);
            if (pairk == NULL || PyList_Append(lst, pairk) < 0) {
              Py_XDECREF(pairk);
              ok = 0;
              break;
            }
            Py_DECREF(pairk);
          }
          Py_DECREF(req);
          if (!ok) {
            Py_DECREF(lst);
            goto item_error;
          }
          if (sz > 1 && PyList_Sort(lst) < 0) {
            Py_DECREF(lst);
            goto item_error;
          }
          PyObject *ckey = PyList_AsTuple(lst);
          Py_DECREF(lst);
          if (ckey == NULL) goto item_error;
          cid = dict_lookup_long(class_ids, ckey);
          Py_DECREF(ckey);
          if (cid < 0) slow = 1;
        }
      }
    }

    if (slow) {
      Py_XDECREF(placement);
      Py_XDECREF(resource);
      Py_XDECREF(rr);
      PyObject *r = PyObject_CallFunction(miss_cb, "n", b);
      if (r == NULL) goto loop_error;
      Py_DECREF(r);
      continue;
    }

    /* ---- fnv32a tiebreak over the uid ---- */
    PyObject *uid = PyObject_GetAttr(resource, s_uid);
    if (uid == NULL) goto item_error;
    int desc = 0;
    if (PyUnicode_Check(uid)) {
      Py_ssize_t ulen = 0;
      const char *udata = PyUnicode_AsUTF8AndSize(uid, &ulen);
      if (udata == NULL) {
        Py_DECREF(uid);
        goto item_error;
      }
      if (ulen > 0) desc = fnv32a(udata, ulen) & 1;
    }
    Py_DECREF(uid);

    int is_workload = (replicas > 0) || (rr != Py_None);

    pid_arr[b] = (int32_t)pid;
    gvk_arr[b] = (int32_t)gid;
    cls_arr[b] = (int32_t)cid;
    rep_arr[b] = (int64_t)replicas;
    uid_arr[b] = (uint8_t)desc;
    fresh_arr[b] = 0; /* reschedule_triggered_at is None on this path */
    nw_arr[b] = (uint8_t)(!is_workload);
    nws_arr[b] = (uint8_t)(replicas == 0); /* no components on this path */
    route_arr[b] = (int32_t)route;
    handled++;

    Py_DECREF(placement);
    Py_DECREF(resource);
    Py_DECREF(rr);
    continue;

  item_error:
    Py_XDECREF(placement);
    Py_XDECREF(resource);
    Py_XDECREF(rr);
    goto loop_error;
  }

  Py_DECREF(fast_items);
  PyBuffer_Release(&b_route);
  PyBuffer_Release(&b_nws);
  PyBuffer_Release(&b_nw);
  PyBuffer_Release(&b_fresh);
  PyBuffer_Release(&b_uid);
  PyBuffer_Release(&b_rep);
  PyBuffer_Release(&b_cls);
  PyBuffer_Release(&b_gvk);
  PyBuffer_Release(&b_pid);
  return PyLong_FromSsize_t(handled);

loop_error:
  Py_DECREF(fast_items);
fail9:
  PyBuffer_Release(&b_route);
fail8:
  PyBuffer_Release(&b_nws);
fail7:
  PyBuffer_Release(&b_nw);
fail6:
  PyBuffer_Release(&b_fresh);
fail5:
  PyBuffer_Release(&b_uid);
fail4:
  PyBuffer_Release(&b_rep);
fail3:
  PyBuffer_Release(&b_cls);
fail2:
  PyBuffer_Release(&b_gvk);
fail1:
  PyBuffer_Release(&b_pid);
  return NULL;
}

/* decode_fast(bounds, c_arr, vv, name_rank, names, non_workload, status,
 *             tc_type, empty_prop, out)
 *
 * Builds the per-binding TargetCluster lists for every binding whose
 * status is 0 and whose out[] slot is still None (errors are Python's).
 * bounds: int64[nb+1] row boundaries into c_arr/vv (row-major COO);
 * name_rank orders construction so each list is name-sorted without a
 * Python sort. Returns None.
 */
static PyObject *decode_fast(PyObject *self, PyObject *args) {
  PyObject *a_bounds, *a_c, *a_v, *a_rank, *names, *a_nw, *a_status;
  PyObject *tc_type, *out;
  int empty_prop = 0;
  if (!PyArg_ParseTuple(args, "OOOOOOOOpO", &a_bounds, &a_c, &a_v, &a_rank,
                        &names, &a_nw, &a_status, &tc_type, &empty_prop,
                        &out))
    return NULL;

  Py_buffer b_bounds, b_c, b_v, b_rank, b_nw, b_status;
  if (PyObject_GetBuffer(a_bounds, &b_bounds, PyBUF_SIMPLE) < 0) return NULL;
  if (PyObject_GetBuffer(a_c, &b_c, PyBUF_SIMPLE) < 0) goto dfail1;
  if (PyObject_GetBuffer(a_v, &b_v, PyBUF_SIMPLE) < 0) goto dfail2;
  if (PyObject_GetBuffer(a_rank, &b_rank, PyBUF_SIMPLE) < 0) goto dfail3;
  if (PyObject_GetBuffer(a_nw, &b_nw, PyBUF_SIMPLE) < 0) goto dfail4;
  if (PyObject_GetBuffer(a_status, &b_status, PyBUF_SIMPLE) < 0) goto dfail5;

  const int64_t *bounds = (const int64_t *)b_bounds.buf;
  const int64_t *c_arr = (const int64_t *)b_c.buf;
  const int64_t *v_arr = (const int64_t *)b_v.buf;
  const int64_t *rank = (const int64_t *)b_rank.buf;
  const uint8_t *nw = (const uint8_t *)b_nw.buf;
  const int32_t *status = (const int32_t *)b_status.buf;
  Py_ssize_t nb = PyList_GET_SIZE(out);

  for (Py_ssize_t b = 0; b < nb; b++) {
    if (status[b] != 0) continue;               /* error: Python's slot */
    if (PyList_GET_ITEM(out, b) != Py_None) continue;
    int64_t lo = bounds[b], hi = bounds[b + 1];
    int64_t m = hi - lo;
    /* wide rows (fleet-wide Duplicated / non-workload selections) would
     * make the insertion sort quadratic — Python's timsort owns them */
    if (m > 256) continue;
    PyObject *targets = PyList_New(0);
    if (targets == NULL) goto dloop_error;

    /* insertion-sort the row by name rank (rows are tiny) */
    int64_t order[64];
    int use_stack = (m <= 64);
    int64_t *ord = order;
    if (!use_stack) {
      ord = (int64_t *)PyMem_Malloc(sizeof(int64_t) * (size_t)m);
      if (ord == NULL) {
        Py_DECREF(targets);
        goto dloop_error;
      }
    }
    for (int64_t j = 0; j < m; j++) ord[j] = lo + j;
    for (int64_t j = 1; j < m; j++) {
      int64_t key = ord[j];
      int64_t kr = rank[c_arr[key]];
      int64_t i = j - 1;
      while (i >= 0 && rank[c_arr[ord[i]]] > kr) {
        ord[i + 1] = ord[i];
        i--;
      }
      ord[i + 1] = key;
    }

    int is_nw = nw[b];
    int ok = 1;
    for (int64_t j = 0; j < m && ok; j++) {
      int64_t e = ord[j];
      int64_t v = v_arr[e];
      long out_rep;
      if (is_nw) {
        out_rep = 0;
      } else if (v > 0) {
        out_rep = (long)v;
      } else if (empty_prop) {
        out_rep = 0;
      } else {
        continue;
      }
      PyObject *name = PyList_GET_ITEM(names, c_arr[e]); /* borrowed */
      PyObject *rep = PyLong_FromLong(out_rep);
      if (rep == NULL) {
        ok = 0;
        break;
      }
      PyObject *tc = PyObject_CallFunctionObjArgs(tc_type, name, rep, NULL);
      Py_DECREF(rep);
      if (tc == NULL || PyList_Append(targets, tc) < 0) {
        Py_XDECREF(tc);
        ok = 0;
        break;
      }
      Py_DECREF(tc);
    }
    if (!use_stack) PyMem_Free(ord);
    if (!ok) {
      Py_DECREF(targets);
      goto dloop_error;
    }
    if (PyList_SetItem(out, b, targets) < 0) goto dloop_error; /* steals */
  }

  PyBuffer_Release(&b_status);
  PyBuffer_Release(&b_nw);
  PyBuffer_Release(&b_rank);
  PyBuffer_Release(&b_v);
  PyBuffer_Release(&b_c);
  PyBuffer_Release(&b_bounds);
  Py_RETURN_NONE;

dloop_error:
  PyBuffer_Release(&b_status);
dfail5:
  PyBuffer_Release(&b_nw);
dfail4:
  PyBuffer_Release(&b_rank);
dfail3:
  PyBuffer_Release(&b_v);
dfail2:
  PyBuffer_Release(&b_c);
dfail1:
  PyBuffer_Release(&b_bounds);
  return NULL;
}

static PyMethodDef methods[] = {
    {"encode_fast", encode_fast, METH_VARARGS,
     "Fast per-binding encode loop; returns count handled."},
    {"decode_fast", decode_fast, METH_VARARGS,
     "Fast per-binding result-list construction."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_encode_fast", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__encode_fast(void) {
  s_placement = PyUnicode_InternFromString("placement");
  s_resource = PyUnicode_InternFromString("resource");
  s_api_version = PyUnicode_InternFromString("api_version");
  s_kind = PyUnicode_InternFromString("kind");
  s_uid = PyUnicode_InternFromString("uid");
  s_replicas = PyUnicode_InternFromString("replicas");
  s_replica_requirements = PyUnicode_InternFromString("replica_requirements");
  s_resource_request = PyUnicode_InternFromString("resource_request");
  s_milli = PyUnicode_InternFromString("milli");
  s_components = PyUnicode_InternFromString("components");
  s_clusters = PyUnicode_InternFromString("clusters");
  s_gets = PyUnicode_InternFromString("graceful_eviction_tasks");
  s_reschedule = PyUnicode_InternFromString("reschedule_triggered_at");
  s_cluster_affinity = PyUnicode_InternFromString("cluster_affinity");
  s_cluster_affinities = PyUnicode_InternFromString("cluster_affinities");
  return PyModule_Create(&module);
}
