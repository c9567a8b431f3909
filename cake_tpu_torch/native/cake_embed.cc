// C-callable embedding shim for the port's workers (the port's copy of
// native/cake_embed.cc, calling cake_tpu_torch.embed).
//
// A host application links this library and calls
//   cake_start_worker(name, model_path, topology_path, address)
// to turn the process into a worker serving its topology-assigned layers,
// or cake_start_worker_opts(..., options_json) to pass start_worker's
// keyword options as a JSON object ({"kv_quant": "int8", "max_seq": 128,
// "device": "cpu", "quantize": "int8"}). Both block until the worker stops
// (SIGTERM or SIGINT) and return 0 on a clean stop, nonzero on an error.
// Called from a process that already runs Python (loaded with ctypes), the
// shim joins that interpreter; otherwise it starts one and finalizes it.
//
// Built at first use by cake_tpu_torch/ops/kernels/build.py build_shim:
//   g++ -O2 -fPIC -shared cake_embed.cc -I<INCLUDEPY> -L<LIBDIR>
//       -lpython3.X -Wl,-rpath,<LIBDIR>
// cake_worker_api_version() is 2: version 1's entry plus
// cake_start_worker_opts.

#include <Python.h>

namespace {

int run_worker(const char *fn_name, const char *name, const char *model_path,
               const char *topology_path, const char *address,
               const char *options) {
  if (!name || !model_path || !topology_path) return 2;

  const bool owned = !Py_IsInitialized();
  if (owned) Py_InitializeEx(0);

  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 0;

  PyObject *mod = PyImport_ImportModule("cake_tpu_torch.embed");
  if (!mod) {
    PyErr_Print();
    rc = 1;
  } else {
    const char *addr = address && *address ? address : "0.0.0.0:10128";
    PyObject *fn = PyObject_GetAttrString(mod, fn_name);
    PyObject *res = nullptr;
    if (fn) {
      res = options
                ? PyObject_CallFunction(fn, "sssss", name, model_path,
                                        topology_path, addr, options)
                : PyObject_CallFunction(fn, "ssss", name, model_path,
                                        topology_path, addr);
    }
    if (!res) {
      PyErr_Print();
      rc = 1;
    } else if (PyLong_Check(res) && PyLong_AsLong(res) != 0) {
      rc = 1;
    }
    Py_XDECREF(res);
    Py_XDECREF(fn);
    Py_DECREF(mod);
  }

  PyGILState_Release(gil);
  if (owned) Py_FinalizeEx();
  return rc;
}

}  // namespace

extern "C" {

int cake_worker_api_version(void) { return 2; }

// Start a worker and block until it stops. Returns 0 on success.
int cake_start_worker(const char *name, const char *model_path,
                      const char *topology_path, const char *address) {
  return run_worker("start_worker", name, model_path, topology_path, address,
                    nullptr);
}

// The same with start_worker's keyword options as a JSON object.
int cake_start_worker_opts(const char *name, const char *model_path,
                           const char *topology_path, const char *address,
                           const char *options) {
  return run_worker("start_worker_opts", name, model_path, topology_path,
                    address, options ? options : "{}");
}

}  // extern "C"
