// a @ b with the K products summed in bk-deep blocks that join the sum
// through Kahan compensation: the precision_level=1 GEMM.
//
// Replaces the TPU kernel `_kahan_gemm_kernel` reached through
// `pallas_kahan_gemm` (veles_tpu/ops/gemm.py), which keeps the accumulator
// and its compensation in VMEM while the grid walks K in 512-deep blocks.
// It serves `kahan_matmul` / `gemm(precision_level=1)` and the
// GEMM-disciplines bench.
//
// Bound on an H100 SXM (67 TFLOP/s float32 without tensor cores, 3.35 TB/s):
// operations at every shape the bench runs. 2*M*N*K float32 operations plus
// 4 per output and K block; fc6 forward (128 x 9216 @ 9216 x 4096) is
// 9.7 GFLOP, at least 0.145 ms, against 0.05 ms to read its operands once.
// With bf16 operands the card's bound is the bf16 tensor-core peak (989
// TFLOP/s), so bytes: 0.024 ms at fc6. Tensor cores are not used here: for
// float32 operands TF32 products would lose the float32 accuracy the
// compensation is there for, and bf16 operands share the one SIMT kernel.
//
// Design, simple first:
// * one block of 256 threads owns a 64 x 64 output tile, 4 x 4 outputs per
//   thread; grid (ceil(N/64), ceil(M/64)), no split-K, since the Kahan sum
//   runs over K in order inside each thread;
// * each output keeps three float32 registers: acc and comp, the Kahan pair,
//   and term, the current bk-deep block's partial product. Operand tiles of
//   16 K values are staged in shared memory (K-major, widened to float32 on
//   the way in, so a bf16 x bf16 product is exact); each tile's 16 products
//   accumulate by FMA into a fourth register that then joins term, which
//   keeps term's rounding error below that of one 512-long FMA chain;
// * at each bk boundary term joins acc as in `_kahan_matmul_loop`:
//   y = term - comp; t = acc + y; comp = (t - acc) - y; acc = t, written
//   with __fsub_rn/__fadd_rn so no contraction or reassociation can touch it;
// * any M, N, K and bk >= 1: ragged edges are masked on load (zero fill) and
//   on store, and a ragged last K block is shorter, which is what the JAX
//   loop's zero padding computes;
// * a (M, K) and b (K, N) are row-major and contiguous (kahan_matmul copies a
//   transposed or strided view once, O(MK) against the O(MNK) product); each
//   tile load puts neighbouring threads on neighbouring addresses;
// * the output is float32; a bfloat16 result is a cast by the caller.
// Not done yet: register prefetch or cp.async double buffering, TMA, and a
// 3xTF32 or wgmma design that keeps float32 accuracy on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // outputs per block along M and along N
constexpr int kPer = 4;              // outputs per thread along M and along N
constexpr int kGroups = kTile / kPer;  // 16 thread groups along each axis
constexpr int kDepth = 16;           // K values staged per shared-memory step
// Row pitch of the K-major tiles: rows stay 16-byte aligned for the float4
// reads, and the stores of a K-contiguous operand meet 2-way bank conflicts
// at most.
constexpr int kPitch = kTile + 4;
constexpr int kLoads = kTile * kDepth / kThreads;  // tile values per thread

static_assert(kGroups * kGroups == kThreads, "one thread per 4 x 4 outputs");
static_assert(kTile * kDepth % kThreads == 0, "tile loads split evenly");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// tile[kk][r] = x[r0 + r, k0 + kk] of an (rows, k) operand, zero outside
// rows and [k0, kend). kColMajor: x[r, kk] lies at kk * ld + r (b, read as
// the (n, k) operand b^T), else at r * ld + kk (a).
template <typename T, bool kColMajor>
__device__ __forceinline__ void stage(float (*tile)[kPitch],
                                      const T* __restrict__ x, int rows,
                                      int r0, int k0, int kend, long long ld) {
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    // neighbouring threads take neighbouring addresses of either layout
    const int r = kColMajor ? i % kTile : i / kDepth;
    const int kk = kColMajor ? i / kTile : i % kDepth;
    const int gr = r0 + r, gk = k0 + kk;
    float v = 0.0f;
    if (gr < rows && gk < kend)
      v = to_f32(kColMajor ? x[(long long)gk * ld + gr]
                           : x[(long long)gr * ld + gk]);
    tile[kk][r] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
kahan_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ out, int m, int n, int k, int bk) {
  __shared__ __align__(16) float as[kDepth][kPitch];  // as[kk][row]
  __shared__ __align__(16) float bs[kDepth][kPitch];  // bs[kk][col]
  const int tx = threadIdx.x % kGroups;
  const int ty = threadIdx.x / kGroups;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[kPer][kPer], comp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = comp[i][j] = 0.0f;

  for (int c0 = 0; c0 < k; c0 += bk) {
    const int cend = k - c0 > bk ? c0 + bk : k;
    float term[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) term[i][j] = 0.0f;

    for (int k0 = c0; k0 < cend; k0 += kDepth) {
      stage<T, false>(as, a, m, row0, k0, cend, k);
      stage<T, true>(bs, b, n, col0, k0, cend, n);
      __syncthreads();
      float part[kPer][kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) part[i][j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * kPer]);
        const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * kPer]);
        const float ar[kPer] = {av.x, av.y, av.z, av.w};
        const float br[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            part[i][j] = fmaf(ar[i], br[j], part[i][j]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          term[i][j] = __fadd_rn(term[i][j], part[i][j]);
    }

    // the compensated add of `_kahan_matmul_loop`, in its order
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float y = __fsub_rn(term[i][j], comp[i][j]);
        const float t = __fadd_rn(acc[i][j], y);
        comp[i][j] = __fsub_rn(__fsub_rn(t, acc[i][j]), y);
        acc[i][j] = t;
      }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty * kPer + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx * kPer + j;
      if (c >= n) continue;
      out[(size_t)r * n + c] = acc[i][j];
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, float* out, int m, int n, int k,
            int bk, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  kahan_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, m, n, k, bk);
}

}  // namespace

// out (m, n) float32 row-major = a (m, k) @ b (k, n), both row-major and
// contiguous, K summed in bk-deep blocks joined by Kahan compensation. a and
// b both float32 (in_bf16 = 0) or both bfloat16 (in_bf16 = 1). m, n >= 1,
// m <= 65535 * 64, k >= 0, bk >= 1. Returns cudaGetLastError() after the
// launch.
extern "C" int veles_kahan_gemm(const void* a, const void* b, void* out, int m,
                                int n, int k, int bk, int in_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (in_bf16)
    launch<__nv_bfloat16>(a, b, o, m, n, k, bk, s);
  else
    launch<float>(a, b, o, m, n, k, bk, s);
  return static_cast<int>(cudaGetLastError());
}
