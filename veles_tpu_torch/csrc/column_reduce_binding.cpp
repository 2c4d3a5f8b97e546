// CPython binding of `veles_column_reduce` (column_reduce.cu) for the
// column sum's wrapper (ops/reduce.py:column_sum).
//
// The fc and head bias gradients (128 x 4096, 128 x 1000) take the kernel
// a few microseconds on an H100, so a call's time is its host time: a
// ctypes call of twelve arguments and a `torch.empty` from Python cost more
// than `torch.sum`'s whole call. Here the arguments are read with the C API
// and the output (and the chunked form's partials) are allocated with
// `at::empty`, on the card and through the caching allocator as
// `torch.empty` would. The kernel's C function is reached through the
// address `bind` is handed once (ops/build.py:binding), so this file links
// to PyTorch's libraries only.

#include <Python.h>

#include <ATen/ops/empty.h>
#include <torch/csrc/autograd/python_variable.h>

namespace {

using ColumnReduce = int (*)(const void* x, void* tickets, void* partial,
                             void* out, long long rows, int cols, int bf16,
                             int vec, int tile, int chunks,
                             long long chunk_rows, void* stream);

ColumnReduce column_reduce = nullptr;

PyObject* bind(PyObject*, PyObject* address) {
  column_reduce = reinterpret_cast<ColumnReduce>(PyLong_AsVoidPtr(address));
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

// column_sum(x, tickets, bf16, vec, tile, chunks, chunk_rows, stream):
// x a contiguous (rows, cols) CUDA tensor on the current card, tickets the
// address of the chunked form's tickets (None in the single form), the
// rest `column_plan`'s and the raw stream. Returns the float32 (cols,)
// sums; raises RuntimeError when the launch fails.
PyObject* column_sum(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 8 || !THPVariable_Check(args[0])) {
    PyErr_SetString(PyExc_TypeError,
                    "column_sum(x, tickets, bf16, vec, tile, chunks, "
                    "chunk_rows, stream) takes a tensor and 7 ints");
    return nullptr;
  }
  if (column_reduce == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, "column_sum: bind() was not called");
    return nullptr;
  }
  const at::Tensor& x = THPVariable_Unpack(args[0]);
  void* tickets = args[1] == Py_None ? nullptr : PyLong_AsVoidPtr(args[1]);
  const int bf16 = static_cast<int>(PyLong_AsLong(args[2]));
  const int vec = static_cast<int>(PyLong_AsLong(args[3]));
  const int tile = static_cast<int>(PyLong_AsLong(args[4]));
  const int chunks = static_cast<int>(PyLong_AsLong(args[5]));
  const long long chunk_rows = PyLong_AsLongLong(args[6]);
  void* stream = PyLong_AsVoidPtr(args[7]);
  if (PyErr_Occurred()) return nullptr;
  const long long rows = x.size(0);
  const int cols = static_cast<int>(x.size(1));
  const auto options = x.options().dtype(at::kFloat);
  at::Tensor out = at::empty({cols}, options);
  at::Tensor partial;
  if (chunks > 1) partial = at::empty({int64_t{chunks} * cols}, options);
  const int status = column_reduce(
      x.data_ptr(), tickets, chunks > 1 ? partial.data_ptr() : nullptr,
      out.data_ptr(), rows, cols, bf16, vec, tile, chunks, chunk_rows,
      stream);
  if (status != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "CUDA kernel column_reduce failed to launch: cudaError %d",
                 status);
    return nullptr;
  }
  return THPVariable_Wrap(std::move(out));
}

PyMethodDef methods[] = {
    {"bind", bind, METH_O,
     "bind(address): the address of veles_column_reduce"},
    {"column_sum", reinterpret_cast<PyCFunction>(
                       reinterpret_cast<void (*)(void)>(column_sum)),
     METH_FASTCALL, "column_sum(x, tickets, bf16, vec, tile, chunks, "
                    "chunk_rows, stream) -> float32 (cols,)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "column_reduce_binding",
                      nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_column_reduce_binding(void) {
  return PyModule_Create(&module);
}
