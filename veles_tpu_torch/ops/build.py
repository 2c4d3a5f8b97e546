"""Build the CUDA sources under ``veles_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with :mod:`ctypes`. Nothing here includes PyTorch's headers, so a
source builds in seconds. Libraries land in ``csrc/build/`` under a
name that carries a hash of the source and the flags: an edited source
builds anew, an unchanged one is reused.

Building happens at first use (:func:`library`), or for every source at
once, in parallel, through :func:`build_all`. Nothing is built when the
module is imported.

:func:`function` and :func:`launch` are the short call path of a
kernel's C function: resolved once with its argument types, then called
with the raw handle of the current stream, inside a device context only
when the tensor's card is not the current one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libraries = {}
_functions = {}


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-len(".cu")] for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME): "
                       "the CUDA kernels cannot be built")


def _target(name):
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name,
                                                 digest.hexdigest()[:16]))


def _start(name, target):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (target, os.getpid())
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish(name, target, proc, tmp, cmd):
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s.cu (exit %d):\n%s\n%s" % (
            name, proc.returncode, " ".join(cmd), output))
    os.replace(tmp, target)


def build_all():
    """Compile every source not built yet, one ``nvcc`` each, all at
    once. Returns ``{name: seconds}`` (0.0 for a library reused)."""
    with _lock:
        started = {}
        seconds = {}
        t0 = time.perf_counter()
        try:
            for name in sources():
                target = _target(name)
                if os.path.exists(target):
                    seconds[name] = 0.0
                else:
                    started[name] = (target,) + _start(name, target)
            for name, (target, proc, tmp, cmd) in started.items():
                _finish(name, target, proc, tmp, cmd)
                seconds[name] = time.perf_counter() - t0
        finally:
            for _, proc, _, _ in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return seconds


def library(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built first if
    needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        target = _target(name)
        if not os.path.exists(target):
            _finish(name, target, *_start(name, target))
        lib = _libraries[name] = ctypes.CDLL(target)
        return lib


def function(name, symbol, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with ``argtypes``
    (the stream's ``c_void_p`` last) and an int status as its result.
    Resolved once, the library built first if needed; after that a call
    is one dictionary lookup, without a lock."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return fn


def launch(fn, device, *args):
    """``fn(*args, stream)`` with the raw handle of ``device``'s current
    stream, read without building a ``torch.cuda.Stream``; inside a device
    context only when ``device`` is not the current card. Returns the C
    function's status. The caller has allocated on the card already, so
    CUDA is initialised and the current card is read without
    ``torch.cuda``'s lazy-init check."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def check(status, kernel):
    """Raise when a launch's ``cudaGetLastError()`` was not success."""
    if status != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (kernel, status))
