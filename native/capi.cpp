// C ABI for libsrcnn_tpu: the reference ships its SRCNN as a C-linkable
// shared library with exactly two entry points (`libsrcnn.h:46-54`,
// `libsrcnn.def:1-2`); this file gives C/C++ clients the same two calls
// against the JAX framework by hosting an embedded CPython interpreter
// that drives `libsrcnn_tpu.api`.
//
// ABI notes vs the reference header:
//   - The reference declares the out-params as C++ references
//     (`unsigned char*& outbuff`, `unsigned& outbuffsz`); references and
//     pointers share the machine-level ABI, so the `extern "C"` surface
//     here uses explicit pointers and is callable from plain C.
//   - Output buffers are malloc()'d; release them with SRCNN_FreeBuffer
//     (the reference hands out new[] storage and leaves delete[] to the
//     caller, `libsrcnn.cpp:869-920`).
//   - Error codes match `libsrcnn.cpp`: 0 ok, -1 bad args (`:951-952`),
//     -2 bad scale (`:963-966`), -11/-12 allocation failures
//     (`:883,:910`), -100 unexpected internal failure (`:948,:968`).
//
// Device selection follows the normal JAX environment: JAX's default
// device (the GPU if present) unless `JAX_PLATFORMS=cpu` pins it to host. Set PYTHONPATH so the embedded interpreter can import
// `libsrcnn_tpu` when the package is not installed.

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>

namespace {

std::mutex g_mu;            // serializes all Python transitions
PyObject* g_api = nullptr;  // libsrcnn_tpu.api module (owned)

// Lock-order safety: these entry points take g_mu THEN the GIL.  A
// caller that already holds the GIL (a Python host app calling through
// ctypes.PyDLL, or an extension that didn't release it) would invert
// that order -- it blocks on g_mu holding the GIL while the g_mu owner
// blocks in PyGILState_Ensure: deadlock.  Yield the caller's GIL for
// the duration of the call; PyGILState_Ensure re-acquires it where
// needed.
struct GilYield {
    PyThreadState* saved = nullptr;
    GilYield() {
        if (Py_IsInitialized() && PyGILState_Check()) {
            saved = PyEval_SaveThread();
        }
    }
    ~GilYield() {
        if (saved != nullptr) {
            PyEval_RestoreThread(saved);
        }
    }
};

// Import libsrcnn_tpu.api once, initializing the interpreter if this
// process has none. Caller must hold g_mu. Returns borrowed-for-lifetime
// module or nullptr (with a message on stderr).
PyObject* api_module() {
    if (g_api != nullptr) {
        return g_api;
    }
    if (!Py_IsInitialized()) {
        PyConfig cfg;
        PyConfig_InitPythonConfig(&cfg);
        // library clients keep their own argv; don't let Python touch it
        cfg.parse_argv = 0;
        cfg.install_signal_handlers = 0;
        PyStatus st = Py_InitializeFromConfig(&cfg);
        PyConfig_Clear(&cfg);
        if (PyStatus_Exception(st)) {
            std::fprintf(stderr, "libsrcnn_tpu_c: CPython init failed: %s\n",
                         st.err_msg ? st.err_msg : "?");
            return nullptr;
        }
        // Drop the GIL acquired by init so every later entry point --
        // from ANY client thread, including retries after a failed
        // import -- can PyGILState_Ensure without deadlocking on the
        // init thread's implicit hold.
        (void)PyEval_SaveThread();
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* mod = PyImport_ImportModule("libsrcnn_tpu.api");
    if (mod == nullptr) {
        PyErr_Print();
        std::fprintf(stderr,
                     "libsrcnn_tpu_c: cannot import libsrcnn_tpu.api "
                     "(is the package installed / on PYTHONPATH?)\n");
    }
    g_api = mod;
    PyGILState_Release(gil);
    return g_api;
}

// Copy a PyBytes into a malloc'd buffer. Returns 0 / -alloc-code.
int bytes_out(PyObject* bytes, unsigned char** buf, unsigned* sz, int alloc_code) {
    Py_ssize_t n = PyBytes_GET_SIZE(bytes);
    unsigned char* p = static_cast<unsigned char*>(std::malloc(n > 0 ? n : 1));
    if (p == nullptr) {
        return alloc_code;
    }
    std::memcpy(p, PyBytes_AS_STRING(bytes), n);
    *buf = p;
    *sz = static_cast<unsigned>(n);
    return 0;
}

}  // namespace

extern "C" {

// Parity constant (`libsrcnn.h:35`).
unsigned SRCNN_Version(void) { return 0x00010A28u; }

void SRCNN_FreeBuffer(unsigned char* p) { std::free(p); }

// Drop-in for `ConfigureFilterSRCNN(SRCNNFilterType, bool)`
// (`libsrcnn.h:46-47`): sets the process-global filter / step-scale state
// consumed by ProcessSRCNN. ftype uses the reference enum values
// (0 nearest .. 4 b-spline).
void ConfigureFilterSRCNN(int ftype, int stepscale) {
    GilYield yield;
    std::lock_guard<std::mutex> lock(g_mu);
    PyObject* api = api_module();
    if (api == nullptr) {
        return;  // reference signature is void; failure already on stderr
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = PyObject_CallMethod(api, "configure_filter_srcnn", "ii",
                                      ftype, stepscale ? 1 : 0);
    if (r == nullptr) {
        PyErr_Print();
    }
    Py_XDECREF(r);
    PyGILState_Release(gil);
}

// Drop-in for `ProcessSRCNN` (`libsrcnn.h:48-54`): super-resolve an
// interleaved u8 RGB(A) buffer by `multiply` using the configured filter.
// outbuff/outbuffsz are required; convbuff/convbuffsz are optional (pass
// NULL to skip the Y-convolution map, as the reference allows,
// `libsrcnn.cpp:889-915`).
int ProcessSRCNN(const unsigned char* refbuff,
                 unsigned w, unsigned h, unsigned d,
                 float multiply,
                 unsigned char** outbuff, unsigned* outbuffsz,
                 unsigned char** convbuff, unsigned* convbuffsz) {
    if (refbuff == nullptr || outbuff == nullptr || outbuffsz == nullptr ||
        w == 0 || h == 0 || d == 0) {
        return -1;  // bad args (`libsrcnn.cpp:951-952`)
    }
    GilYield yield;
    std::lock_guard<std::mutex> lock(g_mu);
    PyObject* api = api_module();
    if (api == nullptr) {
        return -100;
    }
    int rc = -100;
    PyGILState_STATE gil = PyGILState_Ensure();

    const size_t nbytes = static_cast<size_t>(w) * h * d;
    PyObject* buf = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(refbuff),
        static_cast<Py_ssize_t>(nbytes));
    PyObject* res = nullptr;
    if (buf != nullptr) {
        res = PyObject_CallMethod(api, "process_srcnn", "OIIIf",
                                  buf, w, h, d, static_cast<double>(multiply));
    }
    if (res == nullptr) {
        PyErr_Print();
    } else if (!PyTuple_Check(res) || PyTuple_GET_SIZE(res) < 3) {
        // contract skew: process_srcnn must return (rc, out, conv)
        std::fprintf(stderr,
                     "libsrcnn_tpu_c: unexpected process_srcnn return "
                     "(not a 3-tuple)\n");
        rc = -100;
    } else {
        // (retcode, out_u8_array | None, conv_u8_array | None)
        PyObject* code = PyTuple_GetItem(res, 0);   // borrowed
        rc = static_cast<int>(PyLong_AsLong(code));
        if (rc == -1 && PyErr_Occurred()) {
            PyErr_Print();  // non-int retcode, not a real -1
            rc = -100;
        }
        if (rc == 0) {
            PyObject* out = PyTuple_GetItem(res, 1);
            PyObject* ob = PyObject_CallMethod(out, "tobytes", nullptr);
            if (ob == nullptr) {
                PyErr_Print();
                rc = -100;
            } else {
                rc = bytes_out(ob, outbuff, outbuffsz, -11);
                Py_DECREF(ob);
            }
            PyObject* conv = PyTuple_GetItem(res, 2);
            if (rc == 0 && convbuff != nullptr && convbuffsz != nullptr) {
                *convbuff = nullptr;
                *convbuffsz = 0;
                if (conv != Py_None) {
                    PyObject* cb = PyObject_CallMethod(conv, "tobytes", nullptr);
                    if (cb == nullptr) {
                        PyErr_Print();
                        rc = -12;
                    } else {
                        rc = bytes_out(cb, convbuff, convbuffsz, -12);
                        Py_DECREF(cb);
                    }
                    // reference parity: on -12 the output buffer STAYS
                    // with the caller (`libsrcnn.cpp:895-920` returns
                    // retval=-12 with outbuff already memcpy'd); free it
                    // with SRCNN_FreeBuffer as usual
                }
            }
        } else if (rc == -12) {
            // Python-side conv allocation failure: parity keeps the
            // already-built output (`libsrcnn.cpp:895-912`)
            PyObject* out = PyTuple_GetItem(res, 1);
            if (out != Py_None) {
                PyObject* ob = PyObject_CallMethod(out, "tobytes", nullptr);
                if (ob != nullptr) {
                    (void)bytes_out(ob, outbuff, outbuffsz, -11);
                    Py_DECREF(ob);
                } else {
                    PyErr_Print();
                }
            }
        }
    }
    Py_XDECREF(res);
    Py_XDECREF(buf);
    if (PyErr_Occurred()) {
        PyErr_Print();  // never leak a pending exception past the ABI
    }
    PyGILState_Release(gil);
    return rc;
}

}  // extern "C"
