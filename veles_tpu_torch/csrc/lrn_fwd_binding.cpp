// CPython binding of `veles_lrn_fwd` (lrn_fwd.cu) for the LRN forward's
// wrapper (ops/lrn.py:lrn_forward).
//
// The serving path's small batches (batch 1-8, 1-10 MB) take the kernel a
// few microseconds on an H100, so a call's time is its host time: a ctypes
// call of sixteen arguments and a `torch.empty_like` from Python cost more
// than the kernel. Here the arguments are read with the C API and y is
// allocated by `at::detail::empty_cuda`, on x's card through the caching
// allocator (so it starts on 512 bytes, as the vector form needs), like x
// in shape and dtype. The kernel's C function is reached through the
// address `bind` is handed once (ops/build.py:binding), so this file links
// to PyTorch's libraries only.

#include <Python.h>

#include <exception>

#include <ATen/cuda/EmptyTensor.h>
#include <torch/csrc/autograd/python_variable.h>

namespace {

using LrnFwd = int (*)(const void* x, void* y, long long rows, int c,
                       float k, float alpha, float beta, int n,
                       int beta_is_three_quarters, int bf16, int form,
                       int cpt, int lanes, int rows_per_warp, int blocks,
                       void* stream);

LrnFwd lrn_fwd = nullptr;

PyObject* bind(PyObject*, PyObject* address) {
  lrn_fwd = reinterpret_cast<LrnFwd>(PyLong_AsVoidPtr(address));
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

// forward(x, k, alpha, beta, n, beta_is_three_quarters, form, cpt, lanes,
// rows_per_warp, blocks, stream): x a contiguous channels-last float32 or
// bfloat16 CUDA tensor on the current card with rows and channels, the
// rest `lrn_fwd_plan`'s and the raw stream. Returns y like x; raises
// RuntimeError when the allocation or the launch fails.
PyObject* forward(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 12 || !THPVariable_Check(args[0])) {
    PyErr_SetString(PyExc_TypeError,
                    "forward(x, k, alpha, beta, n, beta_is_three_quarters, "
                    "form, cpt, lanes, rows_per_warp, blocks, stream) takes "
                    "a tensor and 11 numbers");
    return nullptr;
  }
  if (lrn_fwd == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, "forward: bind() was not called");
    return nullptr;
  }
  const at::Tensor& x = THPVariable_Unpack(args[0]);
  const double k = PyFloat_AsDouble(args[1]);
  const double alpha = PyFloat_AsDouble(args[2]);
  const double beta = PyFloat_AsDouble(args[3]);
  int ints[7];
  for (int i = 0; i < 7; ++i)
    ints[i] = static_cast<int>(PyLong_AsLong(args[4 + i]));
  void* stream = PyLong_AsVoidPtr(args[11]);
  if (PyErr_Occurred()) return nullptr;
  at::Tensor y;
  try {
    y = at::detail::empty_cuda(x.sizes(), x.scalar_type(), x.device(),
                               std::nullopt);
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_RuntimeError, e.what());
    return nullptr;
  }
  const int c = static_cast<int>(x.size(-1));
  const int status = lrn_fwd(
      x.data_ptr(), y.data_ptr(), x.numel() / c, c, static_cast<float>(k),
      static_cast<float>(alpha), static_cast<float>(beta), ints[0], ints[1],
      x.scalar_type() == at::kBFloat16, ints[2], ints[3], ints[4], ints[5],
      ints[6], stream);
  if (status != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "CUDA kernel lrn_fwd failed to launch: cudaError %d",
                 status);
    return nullptr;
  }
  return THPVariable_Wrap(std::move(y));
}

PyMethodDef methods[] = {
    {"bind", bind, METH_O, "bind(address): the address of veles_lrn_fwd"},
    {"forward", reinterpret_cast<PyCFunction>(
                    reinterpret_cast<void (*)(void)>(forward)),
     METH_FASTCALL, "forward(x, k, alpha, beta, n, beta_is_three_quarters, "
                    "form, cpt, lanes, rows_per_warp, blocks, stream) -> y"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "lrn_fwd_binding", nullptr, -1,
                      methods};

}  // namespace

PyMODINIT_FUNC PyInit_lrn_fwd_binding(void) {
  return PyModule_Create(&module);
}
