// Embeddable pure-C inference ABI of the PyTorch port (the pd_tpu_*
// names and signatures of paddle_tpu/native/capi.cpp; the reference's
// paddle/capi/capi.h: paddle_gradient_machine_create_for_inference /
// _forward).
//
// The shell is native C++; inference runs through the port's Predictor
// (paddle_tpu_torch.serving) by embedding CPython.  A C host links this
// library, calls pd_tpu_init() once, then create/run/destroy.  A
// predictor runs on cuda:0 (pd_tpu_create) unless the caller names a
// place (pd_tpu_create_on: "cpu" or "cuda[:N]", as the CLI's --place).
//
// Build (paddle_tpu_torch/native/__init__.py: load_capi):
//   g++ -O2 -shared -fPIC -std=c++17 -Wl,-Bsymbolic capi.cpp
//       -I$(python include) [-L$(libdir) -lpython3.X]
//       -o libpaddletpu_torch_capi.so
// -Bsymbolic binds the library's own pd_tpu_* symbols inside it, so a
// process that also loads paddle_tpu's library (RTLD_GLOBAL, the same
// names) never calls into the wrong one.

#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

struct Predictor {
  PyObject* obj;            // paddle_tpu_torch.serving.Predictor
  std::vector<std::string> feed_names;
};

struct RunResult {
  std::vector<std::string> payloads;            // raw bytes per output
  std::vector<std::vector<long long>> shapes;
  std::vector<std::string> dtypes;
};

PyObject* serving_module() {
  return PyImport_ImportModule("paddle_tpu_torch.serving");
}

}  // namespace

extern "C" {

// Initialize the embedded interpreter (no-op when hosted inside an
// already-running Python, e.g. when loaded via ctypes).  Returns 0 on ok.
int pd_tpu_init() {
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* m = serving_module();
  int rc = 0;
  if (m == nullptr) {
    set_error_from_python();
    rc = 1;
  } else {
    Py_DECREF(m);
  }
  PyGILState_Release(g);
  if (we_initialized) {
    // Py_InitializeEx leaves THIS thread holding the GIL; release it so
    // any host thread can PyGILState_Ensure in pd_tpu_create/run (the
    // saved thread state is intentionally kept for the process lifetime).
    (void)PyEval_SaveThread();
  }
  return rc;
}

const char* pd_tpu_last_error() { return g_last_error.c_str(); }

// Load a saved inference model directory onto `place` ("cpu",
// "cuda[:N]"; NULL: cuda:0); returns a handle or NULL (the reason in
// pd_tpu_last_error).
void* pd_tpu_create_on(const char* model_dir, const char* place) {
  PyGILState_STATE g = PyGILState_Ensure();
  Predictor* p = nullptr;
  PyObject* m = serving_module();
  if (m != nullptr) {
    PyObject* obj =
        place == nullptr
            ? PyObject_CallMethod(m, "_capi_create", "s", model_dir)
            : PyObject_CallMethod(m, "_capi_create", "ss", model_dir, place);
    if (obj != nullptr) {
      PyObject* names =
          PyObject_CallMethod(m, "_capi_feed_names", "O", obj);
      if (names != nullptr) {
        p = new Predictor();
        p->obj = obj;
        Py_ssize_t n = PyList_Size(names);
        for (Py_ssize_t i = 0; i < n; ++i) {
          p->feed_names.emplace_back(
              PyUnicode_AsUTF8(PyList_GetItem(names, i)));
        }
        Py_DECREF(names);
      } else {
        set_error_from_python();
        Py_DECREF(obj);
      }
    } else {
      set_error_from_python();
    }
    Py_DECREF(m);
  } else {
    set_error_from_python();
  }
  PyGILState_Release(g);
  return p;
}

// Load a saved inference model directory onto cuda:0; returns a handle
// or NULL (the reason in pd_tpu_last_error: no CUDA, a bad model).
void* pd_tpu_create(const char* model_dir) {
  return pd_tpu_create_on(model_dir, nullptr);
}

int pd_tpu_num_feeds(void* handle) {
  return static_cast<int>(static_cast<Predictor*>(handle)->feed_names.size());
}

const char* pd_tpu_feed_name(void* handle, int i) {
  Predictor* p = static_cast<Predictor*>(handle);
  if (i < 0 || i >= static_cast<int>(p->feed_names.size())) return nullptr;
  return p->feed_names[i].c_str();
}

// Run inference.
//   n_feeds inputs: name / raw data / byte length / shape (rank dims) /
//   dtype string ("float32", "int64", ...).
// Returns an opaque result handle (NULL on error); outputs are read back
// with the pd_tpu_result_* accessors and freed with pd_tpu_free_result.
void* pd_tpu_run(void* handle, int n_feeds, const char** names,
                 const void** data, const long long* byte_lens,
                 const long long* const* shapes, const int* ranks,
                 const char** dtypes) {
  Predictor* p = static_cast<Predictor*>(handle);
  PyGILState_STATE g = PyGILState_Ensure();
  RunResult* result = nullptr;
  PyObject *m = nullptr, *py_names = nullptr, *bufs = nullptr,
           *py_shapes = nullptr, *py_dtypes = nullptr, *ret = nullptr;
  m = serving_module();
  if (m == nullptr) goto fail;
  py_names = PyList_New(n_feeds);
  bufs = PyList_New(n_feeds);
  py_shapes = PyList_New(n_feeds);
  py_dtypes = PyList_New(n_feeds);
  for (int i = 0; i < n_feeds; ++i) {
    PyList_SetItem(py_names, i, PyUnicode_FromString(names[i]));
    PyList_SetItem(
        bufs, i,
        PyMemoryView_FromMemory(
            const_cast<char*>(static_cast<const char*>(data[i])),
            static_cast<Py_ssize_t>(byte_lens[i]), PyBUF_READ));
    PyObject* shp = PyTuple_New(ranks[i]);
    for (int d = 0; d < ranks[i]; ++d) {
      PyTuple_SetItem(shp, d, PyLong_FromLongLong(shapes[i][d]));
    }
    PyList_SetItem(py_shapes, i, shp);
    PyList_SetItem(py_dtypes, i, PyUnicode_FromString(dtypes[i]));
  }
  ret = PyObject_CallMethod(m, "_capi_run", "OOOOO", p->obj, py_names, bufs,
                            py_shapes, py_dtypes);
  if (ret == nullptr) goto fail;
  {
    PyObject* payloads = PyTuple_GetItem(ret, 0);
    PyObject* oshapes = PyTuple_GetItem(ret, 1);
    PyObject* odtypes = PyTuple_GetItem(ret, 2);
    result = new RunResult();
    Py_ssize_t n = PyList_Size(payloads);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* b = PyList_GetItem(payloads, i);
      char* raw;
      Py_ssize_t len;
      PyBytes_AsStringAndSize(b, &raw, &len);
      result->payloads.emplace_back(raw, static_cast<size_t>(len));
      PyObject* shp = PyList_GetItem(oshapes, i);
      std::vector<long long> dims;
      for (Py_ssize_t d = 0; d < PyTuple_Size(shp); ++d) {
        dims.push_back(PyLong_AsLongLong(PyTuple_GetItem(shp, d)));
      }
      result->shapes.push_back(dims);
      result->dtypes.emplace_back(
          PyUnicode_AsUTF8(PyList_GetItem(odtypes, i)));
    }
  }
  goto done;
fail:
  set_error_from_python();
done:
  Py_XDECREF(ret);
  Py_XDECREF(py_dtypes);
  Py_XDECREF(py_shapes);
  Py_XDECREF(bufs);
  Py_XDECREF(py_names);
  Py_XDECREF(m);
  PyGILState_Release(g);
  return result;
}

int pd_tpu_result_count(void* result) {
  return static_cast<int>(static_cast<RunResult*>(result)->payloads.size());
}

const void* pd_tpu_result_data(void* result, int i, long long* byte_len) {
  RunResult* r = static_cast<RunResult*>(result);
  *byte_len = static_cast<long long>(r->payloads[i].size());
  return r->payloads[i].data();
}

int pd_tpu_result_rank(void* result, int i) {
  return static_cast<int>(static_cast<RunResult*>(result)->shapes[i].size());
}

long long pd_tpu_result_dim(void* result, int i, int d) {
  return static_cast<RunResult*>(result)->shapes[i][d];
}

const char* pd_tpu_result_dtype(void* result, int i) {
  return static_cast<RunResult*>(result)->dtypes[i].c_str();
}

void pd_tpu_free_result(void* result) {
  delete static_cast<RunResult*>(result);
}

void pd_tpu_destroy(void* handle) {
  Predictor* p = static_cast<Predictor*>(handle);
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(p->obj);
  PyGILState_Release(g);
  delete p;
}

}  // extern "C"
