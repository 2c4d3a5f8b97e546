"""ctypes binding and build driver of the C++ inference runtime under
``native/`` (``veles_tpu/export/native.py``).

The runtime's C interface (``native/src/capi.cc``) is loaded through
:mod:`ctypes`. The port builds the library with CMake into a directory
of its own, ``native/build-torch`` (ignored by git), not the JAX
package's ``native/build``, and holds an exclusive file lock there
while it checks and builds, so processes of either package running
side by side (``pytest -n``) never race one build. A library older than
any source is rebuilt.
"""

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build-torch")
LIBRARY = os.path.join(BUILD_DIR, "libveles_native.so")

_lock = threading.Lock()
_lib = None


def _sources_mtime():
    newest = os.path.getmtime(os.path.join(NATIVE_DIR, "CMakeLists.txt"))
    for base, _, files in os.walk(os.path.join(NATIVE_DIR, "src")):
        for name in files:
            newest = max(newest, os.path.getmtime(os.path.join(base, name)))
    return newest


def build_native(force=False):
    """Build (or reuse) the runtime; returns the library's path."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if force or not os.path.exists(LIBRARY) or \
                    os.path.getmtime(LIBRARY) < _sources_mtime():
                subprocess.run(
                    ["cmake", "-S", NATIVE_DIR, "-B", BUILD_DIR,
                     "-DCMAKE_BUILD_TYPE=Release"],
                    check=True, capture_output=True)
                subprocess.run(
                    ["cmake", "--build", BUILD_DIR, "--parallel"],
                    check=True, capture_output=True)
    return LIBRARY


def runner_path():
    """The command-line runner (``veles_native_run package in.npy
    out.npy``), built if needed."""
    build_native()
    return os.path.join(BUILD_DIR, "veles_native_run")


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.vt_load.restype = ctypes.c_void_p
    lib.vt_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.vt_free.restype = None
    lib.vt_free.argtypes = [ctypes.c_void_p]
    lib.vt_input_size.restype = ctypes.c_int64
    lib.vt_input_size.argtypes = [ctypes.c_void_p]
    lib.vt_output_size.restype = ctypes.c_int64
    lib.vt_output_size.argtypes = [ctypes.c_void_p]
    lib.vt_unit_count.restype = ctypes.c_int
    lib.vt_unit_count.argtypes = [ctypes.c_void_p]
    lib.vt_run.restype = ctypes.c_int
    lib.vt_run.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


class NativeWorkflow(object):
    """A package loaded into the C++ runtime; ``run`` executes it on
    the host."""

    def __init__(self, package_path):
        self._lib = _load_library()
        self._handle = None
        err = ctypes.create_string_buffer(1024)
        handle = self._lib.vt_load(str(package_path).encode(), err,
                                   len(err))
        if not handle:
            raise RuntimeError("native load failed: %s"
                               % err.value.decode(errors="replace"))
        self._handle = handle

    @property
    def input_size(self):
        return self._lib.vt_input_size(self._handle)

    @property
    def output_size(self):
        return self._lib.vt_output_size(self._handle)

    @property
    def unit_count(self):
        return self._lib.vt_unit_count(self._handle)

    def run(self, batch):
        """(n, *sample_shape) floats -> (n, output_size) float32."""
        batch = numpy.ascontiguousarray(batch, numpy.float32)
        n = batch.shape[0]
        if batch.size != n * self.input_size:
            raise ValueError("sample size %d != the package's input %d"
                             % (batch.size // max(n, 1), self.input_size))
        out = numpy.empty((n, self.output_size), numpy.float32)
        err = ctypes.create_string_buffer(1024)
        rc = self._lib.vt_run(
            self._handle,
            batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            err, len(err))
        if rc != 0:
            raise RuntimeError("native run failed: %s"
                               % err.value.decode(errors="replace"))
        return out

    def close(self):
        if self._handle:
            self._lib.vt_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
