"""Compute ops of the port (``veles_tpu/ops``). Each kernel the JAX
package wrote in Pallas is a CUDA kernel under ``csrc/`` with its plain
PyTorch version beside it; what the JAX package left to XLA is plain
PyTorch here. Importing this package loads no CUDA library: a kernel is
built and loaded at its first launch (``ops/build.py``).

=====================  ===============================================
JAX package            this package
=====================  ===============================================
``ops.gemm``           :mod:`.gemm` (``gemm`` levels 0/1/2; K1/K2
                       ``gemm_bias_act.cu``, K5 ``kahan_gemm.cu``)
``ops.lrn``            :mod:`.lrn` (K3 ``lrn_fwd.cu``, K4 ``lrn_bwd.cu``)
``ops.reduce``         :mod:`.reduce` (``matrix_reduce``; K6
                       ``column_reduce.cu``)
``ops.random``         :mod:`.random` (K7 ``uniform_fill.cu``)
``ops.gather``         :mod:`.gather`
``ops.normalize``      :mod:`.normalize`
``ops.join``           :mod:`.join`
``ops.benchmark``      :mod:`.benchmark`
``ops.autotune``       not ported
=====================  ===============================================
"""

from veles_tpu_torch.ops.gemm import gemm  # noqa: F401
from veles_tpu_torch.ops.reduce import matrix_reduce  # noqa: F401
from veles_tpu_torch.ops.gather import gather_minibatch  # noqa: F401
from veles_tpu_torch.ops.normalize import mean_disp_normalize  # noqa: F401
from veles_tpu_torch.ops.join import join_arrays  # noqa: F401
