"""Build the CUDA sources under ``veles_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with :mod:`ctypes`. Nothing there includes PyTorch's headers, so a
source builds in seconds. A ``csrc/<name>_binding.cpp`` is a CPython
module that calls ``<name>.cu``'s C function with PyTorch tensors, for a
wrapper whose host time is the point: the host compiler builds it
against PyTorch's headers (the paths of
``torch.utils.cpp_extension.include_paths()``) and libraries, without
``ninja``. Libraries land in ``csrc/build/`` under a name that carries a
hash of the source, of every ``csrc/*.cuh`` header for a kernel, and of
the command: an edited source or header builds anew, an unchanged one is
reused.

Building happens at first use (:func:`library`, :func:`binding`), or for
every source at once, in parallel, through :func:`build_all`. Nothing is
built when the module is imported.

:func:`function` and :func:`launch` are the short call path of a
kernel's C function (or of a binding's function): resolved once, then
called with the raw handle of the current stream, inside a device
context only when the tensor's card is not the current one.
"""

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: streaming multiprocessors of the card the sources are built for (an
#: H100 SXM): the plans size their grids by it
SMS = 132

_lock = threading.Lock()
_libraries = {}
_bindings = {}
_functions = {}


def sources():
    """The source files: every ``csrc/<name>.cu`` and
    ``csrc/<name>_binding.cpp``."""
    return sorted(f for f in os.listdir(CSRC)
                  if f.endswith(".cu") or f.endswith("_binding.cpp"))


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


def cxx():
    found = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler (g++, c++ or $CXX): the "
                       "bindings cannot be built")


def _command(source, out):
    """The compiler command that builds ``csrc/<source>`` into ``out``."""
    path = os.path.join(CSRC, source)
    if source.endswith(".cu"):
        return [nvcc(), *NVCC_FLAGS, "-o", out, path]
    root = os.path.dirname(torch.__file__)
    lib = os.path.join(root, "lib")
    return [cxx(), "-O2", "-std=c++17", "-shared", "-fPIC",
            "-D_GLIBCXX_USE_CXX11_ABI=%d" % int(
                torch._C._GLIBCXX_USE_CXX11_ABI),
            "-I", os.path.join(root, "include"),
            "-I", os.path.join(root, "include", "torch", "csrc", "api",
                               "include"),
            "-I", sysconfig.get_paths()["include"], "-o", out, path,
            "-L", lib, "-lc10", "-ltorch", "-ltorch_cpu", "-ltorch_cuda",
            "-ltorch_python", "-Wl,-rpath," + lib]


def headers():
    """The headers the kernels include: every ``csrc/*.cuh``."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def _target(source):
    """The library's path: the source's stem and a hash of the source,
    of every header for a ``.cu`` source, and of its command (with the
    placeholder output name)."""
    digest = hashlib.sha256()
    for name in [source] + (headers() if source.endswith(".cu") else []):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(_command(source, "out")).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (
        source.rsplit(".", 1)[0], digest.hexdigest()[:16]))


def _start(source, target):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (target, os.getpid())
    cmd = _command(source, tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish(source, target, proc, tmp, cmd):
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("%s failed on %s (exit %d):\n%s\n%s" % (
            os.path.basename(cmd[0]), source, proc.returncode,
            " ".join(cmd), output))
    os.replace(tmp, target)


def _built(source):
    """The library of ``csrc/<source>``, built first if needed (the
    caller holds the lock)."""
    target = _target(source)
    if not os.path.exists(target):
        _finish(source, target, *_start(source, target))
    return target


def build_all():
    """Compile every source not built yet, one compiler each, all at
    once. Returns ``{source: seconds}`` (0.0 for a library reused)."""
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
        if lib is None:
            lib = _libraries[name] = ctypes.CDLL(_built(name + ".cu"))
        return lib


def binding(name, symbol):
    """The loaded CPython module of ``csrc/<name>_binding.cpp``, built
    first if needed, handed the address of ``<name>.cu``'s C function
    ``symbol`` once (its ``bind``). Lock-free after the first call."""
    module = _bindings.get(name)
    if module is not None:
        return module
    address = ctypes.cast(getattr(library(name), symbol),
                          ctypes.c_void_p).value
    with _lock:
        module = _bindings.get(name)
        if module is None:
            stem = name + "_binding"
            spec = importlib.util.spec_from_file_location(
                stem, _built(stem + ".cpp"))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            module.bind(address)
            _bindings[name] = module
        return module


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


def stream(device):
    """(card index, raw handle of its current stream) for ``device``, a
    CUDA ``torch.device``, read without building a ``torch.cuda.Stream``
    and without ``torch.cuda``'s lazy-init check (the caller has
    allocated on the card already, so CUDA is initialised)."""
    index = torch._C._cuda_getDevice() if device.index is None \
        else device.index
    return index, torch._C._cuda_getCurrentRawStream(index)


def launch(fn, device, *args):
    """``fn(*args, stream)`` with the raw handle of ``device``'s current
    stream (:func:`stream`); inside a device context only when ``device``
    is not the current card. Returns what ``fn`` returns: a C function's
    status, a binding's result."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    handle = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        return fn(*args, handle)
    with torch.cuda.device(index):
        return fn(*args, handle)


def check(status, kernel):
    """Raise when a launch's ``cudaGetLastError()`` was not success."""
    if status != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (kernel, status))
