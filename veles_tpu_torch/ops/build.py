"""Build the CUDA sources under ``veles_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with :mod:`ctypes`. Nothing there includes PyTorch's headers, so a
source builds in seconds. A ``csrc/<name>_binding.cpp`` is a CPython
module that calls ``<name>.cu``'s C function with PyTorch tensors, for a
wrapper whose host time is the point: the host compiler builds it
against PyTorch's headers (the paths of
``torch.utils.cpp_extension.include_paths()``) and libraries, without
``ninja``. A library's name carries a hash of the source, of every
``csrc/*.cuh`` header for a kernel, and of the command (which names the
source by its absolute path): an edited source or header builds anew,
an unchanged one is reused.

The sources are the ``csrc/`` beside this package, wherever it is
installed (the wheel ships them). A library already built is used
wherever it lies: in ``csrc/build/`` (a checkout, or an install
prebuilt by ``python -m veles_tpu_torch.ops.build``, read-only
included) or in the per-user cache. A new build goes to ``csrc/build/``
when that directory can be written, else to
``${XDG_CACHE_HOME:-~/.cache}/veles_tpu_torch/kernels/`` (a service
user running a package that root installed).

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
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
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


def _listing():
    """The names in ``csrc/``; a missing ``csrc/`` raises."""
    if not os.path.isdir(CSRC):
        raise RuntimeError(
            "%s does not exist: this install of veles_tpu_torch lacks the "
            "kernel sources, so no CUDA kernel can be built (install it "
            "from a wheel or tree that ships veles_tpu_torch/csrc)" % CSRC)
    return os.listdir(CSRC)


def sources():
    """The source files: every ``csrc/<name>.cu`` and
    ``csrc/<name>_binding.cpp``."""
    return sorted(f for f in _listing()
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
    return sorted(f for f in _listing() if f.endswith(".cuh"))


def cache_dir():
    """The per-user directory of libraries built where ``csrc/build/``
    cannot be written."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "veles_tpu_torch", "kernels")


def _writable(directory):
    """Whether a library can be written into ``directory`` (made if
    missing): a file created there and removed. File modes would not
    say, since root writes past them."""
    try:
        os.makedirs(directory, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=directory, prefix=".probe-")
    except OSError:
        return False
    os.close(fd)
    os.unlink(probe)
    return True


def _target(source):
    """The library's path: the source's stem and a hash of the source,
    of every header for a ``.cu`` source, and of its command (with the
    placeholder output name); in ``BUILD_DIR`` or the per-user cache,
    wherever it was built, else where a new build goes (``BUILD_DIR``
    when it can be written)."""
    digest = hashlib.sha256()
    _listing()
    for name in [source] + (headers() if source.endswith(".cu") else []):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(_command(source, "out")).encode())
    name = "%s-%s.so" % (source.rsplit(".", 1)[0], digest.hexdigest()[:16])
    for directory in (BUILD_DIR, cache_dir()):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    return os.path.join(
        BUILD_DIR if _writable(BUILD_DIR) else cache_dir(), name)


def _start(source, target):
    """The compiler started on ``source`` into a file of this process
    beside ``target``, its output into another (so that a caller can
    poll it without reading a pipe)."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = "%s.%d.tmp" % (target, os.getpid())
    cmd = _command(source, tmp)
    with open(tmp + ".log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, cmd


def _finish(source, target, proc, tmp, cmd):
    proc.wait()
    with open(tmp + ".log", errors="replace") as f:
        output = f.read()
    os.unlink(tmp + ".log")
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
    once. Returns ``{source: seconds}``, each from the start to the end
    of its compiler (0.0 for a library reused)."""
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
            running = dict(started)
            while running:
                for name in [n for n, (_, proc, _, _) in running.items()
                             if proc.poll() is not None]:
                    seconds[name] = time.perf_counter() - t0
                    _finish(name, *running.pop(name))
                time.sleep(0.05)
        finally:
            for _, proc, tmp, _ in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for path in (tmp, tmp + ".log"):
                    if os.path.exists(path):
                        os.unlink(path)
        return seconds


def loaded():
    """{source: path} of every library this process has loaded."""
    out = {name + ".cu": lib._name for name, lib in _libraries.items()}
    out.update((name + "_binding.cpp", module.__file__)
               for name, module in _bindings.items())
    return out


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


def main():
    """Build every source not built yet (``python -m
    veles_tpu_torch.ops.build``): a line a source with its seconds and
    its library, then the wall, then the same as one JSON line."""
    t0 = time.perf_counter()
    seconds = build_all()
    wall = time.perf_counter() - t0
    libraries = {name: _target(name) for name in seconds}
    for name in sorted(seconds):
        print("%-28s %7.1f s  %s" % (name, seconds[name], libraries[name]))
    print("wall %.1f s (all sources at once; 0.0 s: built before)" % wall)
    print(json.dumps({"seconds": seconds, "wall_s": wall,
                      "libraries": libraries}))
    return 0


if __name__ == "__main__":
    # run through the package's module, not this file's second copy
    from veles_tpu_torch.ops import build as _build
    sys.exit(_build.main())
