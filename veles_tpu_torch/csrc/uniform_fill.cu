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
// bound by its launch and its one wave's latency, and a call from Python by
// its host time. Philox costs 10 rounds of two 32 x 32 -> 64-bit multiplies
// per four values, well inside the card's integer rate.
//
// Design: the wrapper reaches this function through a CPython binding
// (uniform_fill_binding.cpp) that allocates the output and launches in one
// C call. Each thread takes kCounters counters of one block's span, 256
// apart, so a warp's 16-byte streaming stores of four values each are
// contiguous; the grid is at most one wave (kSms x kBlocksPerSm blocks of
// 256 threads), grid-stride beyond. Each round's products are written as
// one 32 x 32 -> 64-bit multiply: two IMAD.WIDE.U32 a round and no IMAD.HI
// in the SASS (cuobjdump -sass on an H100 build: 39 IMAD.WIDE.U32 for the
// two counters' 20 unrolled rounds, which share the first round's
// kM1 * offset product; a product written as `*` and `__umulhi` compiles
// to the same one instruction; PERF.md). 1, 2 and 4 counters a thread took
// the same device time for a (128, 4096) mask. The map's products are
// rounded one at a time (__fmul_rn, __fadd_rn, no fused multiply-add), so
// the plain PyTorch version (ops/random.py) gives the same bits; the bits
// are a function of the element index alone, whatever the grid.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef VELES_UNIFORM_COUNTERS
#define VELES_UNIFORM_COUNTERS 2
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = VELES_UNIFORM_COUNTERS;  // counters a thread
constexpr int kSms = 132;        // ops/build.py SMS: an H100 SXM
constexpr int kBlocksPerSm = 8;  // 2048 resident threads an SM
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
    const uint64_t p0 = static_cast<uint64_t>(kM0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(kM1) * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ k0,
                   static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ k1,
                   static_cast<uint32_t>(p0));
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
  const long long whole = n / 4;  // counters whose four values all fit
  constexpr long long kSpan = (long long)kThreads * kCounters;
  for (long long base = (long long)blockIdx.x * kSpan; base < counters;
       base += (long long)gridDim.x * kSpan) {
#pragma unroll
    for (int j = 0; j < kCounters; ++j) {
      const long long i = base + j * kThreads + threadIdx.x;
      if (i >= counters) break;
      const uint4 bits = philox4x32_10(
          make_uint4((uint32_t)i, (uint32_t)((unsigned long long)i >> 32),
                     o0, o1),
          k0, k1);
      if (i < whole) {
        __stcs(reinterpret_cast<float4*>(out) + i,
               make_float4(to_unit(bits.x, vmin, range),
                           to_unit(bits.y, vmin, range),
                           to_unit(bits.z, vmin, range),
                           to_unit(bits.w, vmin, range)));
      } else {
        const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
        for (long long e = 4 * i; e < n; ++e)
          out[e] = to_unit(words[e - 4 * i], vmin, range);
      }
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
  const long long span = (long long)kThreads * kCounters;
  const long long blocks_needed = (counters + span - 1) / span;
  const int blocks = (int)(blocks_needed < kSms * kBlocksPerSm
                               ? blocks_needed
                               : kSms * kBlocksPerSm);
  uniform_fill_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, (uint32_t)seed, (uint32_t)(seed >> 32),
      (uint32_t)offset, (uint32_t)(offset >> 32), vmin, vmax - vmin);
  return static_cast<int>(cudaGetLastError());
}
