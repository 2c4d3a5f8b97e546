// CPython binding of `veles_uniform_fill` (uniform_fill.cu) for the fill's
// wrapper (ops/random.py:uniform_fill).
//
// A (128, 4096) dropout mask takes the kernel a few microseconds on an
// H100, so a call's time is its host time: a ctypes call of seven arguments
// and a `torch.empty` from Python cost more than the kernel. Here the
// arguments are read with the C API and the output is allocated by
// `at::detail::empty_cuda`, on the card through the caching allocator, the
// function `torch.empty` reaches on a card, without the dispatcher's round
// trip. vmin and vmax are read as doubles and cast to float, the rounding a
// ctypes `c_float` argument takes. The kernel's C function is reached
// through the address `bind` is handed once (ops/build.py:binding), so this
// file links to PyTorch's libraries only.

#include <Python.h>

#include <exception>

#include <ATen/cuda/EmptyTensor.h>
#include <torch/csrc/autograd/python_variable.h>

namespace {

using UniformFill = int (*)(void* out, long long n, unsigned long long seed,
                            unsigned long long offset, float vmin,
                            float vmax, void* stream);

UniformFill uniform_fill = nullptr;

PyObject* bind(PyObject*, PyObject* address) {
  uniform_fill = reinterpret_cast<UniformFill>(PyLong_AsVoidPtr(address));
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

// fill(rows, cols, seed, offset, vmin, vmax, card, stream): a float32
// (rows, cols) tensor on CUDA card `card` (-1: the current one) filled from
// stream (seed, offset) on [vmin, vmax), launched on the raw stream
// `stream`. rows * cols > 0. Raises RuntimeError when the allocation or the
// launch fails.
PyObject* fill(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 8) {
    PyErr_SetString(PyExc_TypeError,
                    "fill(rows, cols, seed, offset, vmin, vmax, card, "
                    "stream) takes 8 arguments");
    return nullptr;
  }
  if (uniform_fill == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, "fill: bind() was not called");
    return nullptr;
  }
  const long long rows = PyLong_AsLongLong(args[0]);
  const long long cols = PyLong_AsLongLong(args[1]);
  const unsigned long long seed = PyLong_AsUnsignedLongLong(args[2]);
  const unsigned long long offset = PyLong_AsUnsignedLongLong(args[3]);
  const double vmin = PyFloat_AsDouble(args[4]);
  const double vmax = PyFloat_AsDouble(args[5]);
  const long card = PyLong_AsLong(args[6]);
  void* stream = PyLong_AsVoidPtr(args[7]);
  if (PyErr_Occurred()) return nullptr;
  at::Tensor out;
  try {
    out = at::detail::empty_cuda(
        {rows, cols}, at::kFloat,
        c10::Device(c10::DeviceType::CUDA,
                    static_cast<c10::DeviceIndex>(card)),
        std::nullopt);
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_RuntimeError, e.what());
    return nullptr;
  }
  const int status =
      uniform_fill(out.data_ptr(), rows * cols, seed, offset,
                   static_cast<float>(vmin), static_cast<float>(vmax),
                   stream);
  if (status != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "CUDA kernel uniform_fill failed to launch: cudaError %d",
                 status);
    return nullptr;
  }
  return THPVariable_Wrap(std::move(out));
}

PyMethodDef methods[] = {
    {"bind", bind, METH_O, "bind(address): the address of veles_uniform_fill"},
    {"fill", reinterpret_cast<PyCFunction>(
                 reinterpret_cast<void (*)(void)>(fill)),
     METH_FASTCALL, "fill(rows, cols, seed, offset, vmin, vmax, card, "
                    "stream) -> float32 (rows, cols)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "uniform_fill_binding",
                      nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_uniform_fill_binding(void) {
  return PyModule_Create(&module);
}
