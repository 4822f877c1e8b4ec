"""C ABI (native/capi.cpp) end-to-end: a plain-C client linked against
``libsrcnn_tpu_c.so`` must produce byte-identical output to the in-process
Python API.

The reference's primary artifact is a C-linkable shared library with two
entry points (`libsrcnn.h:46-54`, `libsrcnn.def:1-2`); this exercises our
equivalent the way the reference test app uses it (`test.cpp:653-672`):
configure, process, write buffers, free.  The driver subprocess embeds its
own CPython + JAX, pinned to CPU like every other test here.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from libsrcnn_tpu import api
from libsrcnn_tpu.config import FilterType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
DRIVER_SRC = os.path.join(REPO, "tests", "capi_driver.c")

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or shutil.which("python3-config") is None,
    reason="C toolchain not available")


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    lib = os.path.join(NATIVE, "libsrcnn_tpu_c.so")
    try:
        subprocess.run(["make", "-C", NATIVE, "capi"], capture_output=True,
                       timeout=180, check=True)
    except Exception as e:  # missing libpython dev files etc.
        pytest.skip(f"cannot build C ABI library: {e}")
    exe = str(tmp_path_factory.mktemp("capi") / "capi_driver")
    subprocess.run(["gcc", "-O2", "-o", exe, DRIVER_SRC,
                    "-L" + NATIVE, "-lsrcnn_tpu_c", "-Wl,-rpath," + NATIVE],
                   capture_output=True, timeout=120, check=True)
    return exe


def _run_driver(exe, tmp, img, multiply, filt):
    h, w, d = img.shape
    raw = tmp / "in.raw"
    out_f, conv_f = tmp / "out.raw", tmp / "conv.raw"
    img.tofile(raw)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [exe, str(raw), str(w), str(h), str(d), str(multiply), str(int(filt)),
         str(out_f), str(conv_f)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    return (np.fromfile(out_f, np.uint8), np.fromfile(conv_f, np.uint8))


@pytest.mark.parametrize("d,filt", [(3, FilterType.BICUBIC),
                                    (4, FilterType.LANCZOS3)])
def test_c_client_matches_python(driver, tmp_path, d, filt):
    rng = np.random.default_rng(31 + d)
    img = rng.integers(0, 256, (16, 24, d), np.uint8)
    c_out, c_conv = _run_driver(driver, tmp_path, img, 2.0, filt)

    api.configure_filter_srcnn(filt, False)
    rc, out, conv = api.process_srcnn(img.ravel(), 24, 16, d, 2.0)
    api.configure_filter_srcnn(FilterType.BICUBIC, False)  # restore default
    assert rc == 0
    np.testing.assert_array_equal(c_out, out)
    np.testing.assert_array_equal(c_conv, conv)


def test_pydll_gil_holding_caller(driver):
    """A Python host that calls through ctypes.PyDLL keeps the GIL held
    across the call -- the lock order (g_mu then GIL) would deadlock
    without capi.cpp's GilYield.  This exercises that path in-process:
    the embedded interpreter is THIS one (Py_IsInitialized is true), so
    the call must release our GIL, take the mutex, and re-ensure."""
    import ctypes

    lib = ctypes.PyDLL(os.path.join(NATIVE, "libsrcnn_tpu_c.so"))
    lib.SRCNN_Version.restype = ctypes.c_uint
    assert lib.SRCNN_Version() == 0x00010A28

    lib.ProcessSRCNN.restype = ctypes.c_int
    lib.ProcessSRCNN.argtypes = [
        ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_uint)]
    lib.SRCNN_FreeBuffer.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]

    img = np.random.default_rng(15).integers(0, 256, (10, 12, 3), np.uint8)
    lib.ConfigureFilterSRCNN(2, 0)
    out = ctypes.POINTER(ctypes.c_ubyte)()
    outsz = ctypes.c_uint(0)
    rc = lib.ProcessSRCNN(img.tobytes(), 12, 10, 3, 2.0,
                          ctypes.byref(out), ctypes.byref(outsz),
                          None, None)
    assert rc == 0 and outsz.value == 24 * 20 * 3
    got = np.ctypeslib.as_array(out, shape=(outsz.value,)).copy()
    lib.SRCNN_FreeBuffer(out)

    want_rc, want, _ = api.process_srcnn(img.tobytes(), 12, 10, 3, 2.0)
    assert want_rc == 0
    np.testing.assert_array_equal(got, want)
