// Uniform fill from a counter-based generator, Philox4x32-10:
//   out[e] = vmin + (vmax - vmin) * ((word >> 8) * 2^-24)
// where word is 32-bit word e % 4 of Philox4x32-10 at
//   key     = (seed & 0xffffffff, seed >> 32),
//   counter = ((e / 4) & 0xffffffff, (e / 4) >> 32,
//              offset & 0xffffffff, offset >> 32).
//
// Replaces the TPU kernel of `pallas_uniform` (veles_tpu/ops/random.py),
// which draws the TPU's hardware PRNG; those bits cannot be reproduced on
// a GPU, so the generator is Philox and only the bits -> float map (the top
// 24 bits, scaled by 2^-24, a value in [0, 1) on a 2^-24 grid) is carried
// over. It draws the dropout masks of fc6 and fc7: (128, 4096) per step.
//
// Bound on an H100 SXM (3.35 TB/s): writing 4 bytes per value; a (128, 4096)
// mask is 2.1 MB, 0.6 us, far below a launch, so at that size the kernel is
// bound by its launch. Philox costs ~10 rounds of two 32-bit multiplies per
// four values, well inside the card's integer rate.
//
// Design: one thread per counter, four values per thread, written as one
// 16-byte store where all four fall inside the output; a grid-stride loop
// covers any size. The products of the map are rounded one at a time
// (__fmul_rn, __fadd_rn, no fused multiply-add), so the plain PyTorch
// version (ops/random.py) gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t word, float vmin,
                                         float range) {
  const float u = __fmul_rn((float)(word >> 8), 1.0f / 16777216.0f);
  return __fadd_rn(vmin, __fmul_rn(range, u));
}

__global__ void __launch_bounds__(kThreads)
uniform_fill_kernel(float* __restrict__ out, long long n, uint32_t k0,
                    uint32_t k1, uint32_t o0, uint32_t o1, float vmin,
                    float range) {
  const long long counters = (n + 3) / 4;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < counters; i += (long long)gridDim.x * kThreads) {
    const uint4 bits = philox4x32_10(
        make_uint4((uint32_t)i, (uint32_t)((unsigned long long)i >> 32), o0,
                   o1),
        k0, k1);
    const long long e = 4 * i;
    if (e + 3 < n) {
      reinterpret_cast<float4*>(out)[i] =
          make_float4(to_unit(bits.x, vmin, range),
                      to_unit(bits.y, vmin, range),
                      to_unit(bits.z, vmin, range),
                      to_unit(bits.w, vmin, range));
    } else {
      const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
      for (int j = 0; e + j < n; ++j) out[e + j] = to_unit(words[j], vmin,
                                                           range);
    }
  }
}

}  // namespace

// out: n contiguous float32, 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int veles_uniform_fill(void* out, long long n,
                                  unsigned long long seed,
                                  unsigned long long offset, float vmin,
                                  float vmax, void* stream) {
  const long long counters = (n + 3) / 4;
  const long long blocks_needed = (counters + kThreads - 1) / kThreads;
  const int blocks = (int)(blocks_needed < 65536 ? blocks_needed : 65536);
  uniform_fill_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, (uint32_t)seed, (uint32_t)(seed >> 32),
      (uint32_t)offset, (uint32_t)(offset >> 32), vmin, vmax - vmin);
  return static_cast<int>(cudaGetLastError());
}
