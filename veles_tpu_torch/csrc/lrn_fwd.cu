// Cross-channel local response normalization, forward:
//   y = x * (k + alpha * W(x^2))^-beta
// with W the n-wide (n odd) channel window [c - n/2, c + n/2], zero outside
// the row, over channels-last rows (R, C).
//
// Replaces the TPU kernel `_fwd_kernel` reached through `_call_fwd` and
// `lrn_fused` (veles_tpu/ops/lrn.py). It computes the LRN after AlexNet's
// conv1 (rows B*56*56, C = 96) and conv2 (rows B*27*27, C = 256).
//
// Bound on an H100 SXM (3.35 TB/s): memory. It reads R*C values and writes
// R*C values and does ~n + 10 operations per value, far below the card's
// operations-per-byte balance. At B = 64, float32, the conv1 LRN moves 154 MB
// (46 us at least) and the conv2 LRN 96 MB (29 us).
//
// Design: one warp per row (grid-stride over rows), lanes on neighbouring
// channels so every load and store is coalesced. The row's squares are staged
// in shared memory (one C-float slice per warp), so the window sum reads
// shared memory and device memory is touched once per value each way (the
// second read of x hits L1). d^-beta takes the rsqrt chain of the TPU kernel
// for beta = 3/4 (rsqrt(d)^2 * rsqrt(rsqrt(d))), else exp(-beta * log d).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows,
               int c, float k, float alpha, float beta, int half,
               int beta_is_three_quarters) {
  extern __shared__ float squares[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* sq = squares + warp * c;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const T* xr = x + row * c;
    T* yr = y + row * c;
    for (int ch = lane; ch < c; ch += 32) {
      const float v = to_f32(xr[ch]);
      sq[ch] = v * v;
    }
    __syncwarp();
    for (int ch = lane; ch < c; ch += 32) {
      const int lo = max(ch - half, 0);
      const int hi = min(ch + half, c - 1);
      float window = 0.0f;
      for (int j = lo; j <= hi; ++j) window += sq[j];
      const float d = k + alpha * window;
      float q;
      if (beta_is_three_quarters) {
        const float s = rsqrtf(d);  // d^-1/2
        q = s * s * rsqrtf(s);      // d^-1 * d^1/4
      } else {
        q = expf(-beta * logf(d));
      }
      store_out(yr + ch, to_f32(xr[ch]) * q);
    }
    __syncwarp();  // the next row overwrites sq
  }
}

}  // namespace

// x, y: (rows, c) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// n must be odd; the launch takes 8 * c * 4 bytes of shared memory, which
// the wrapper holds to the 48 KB a launch may take without opting in.
// Returns cudaGetLastError() after the launch.
extern "C" int veles_lrn_fwd(const void* x, void* y, long long rows, int c,
                             float k, float alpha, float beta, int n,
                             int beta_is_three_quarters, int bf16,
                             void* stream) {
  const long long blocks_needed = (rows + kWarps - 1) / kWarps;
  const int blocks = (int)(blocks_needed < (1LL << 30) ? blocks_needed
                                                       : (1LL << 30));
  const size_t smem = (size_t)kWarps * c * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    lrn_fwd_kernel<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        rows, c, k, alpha, beta, n / 2, beta_is_three_quarters);
  } else {
    lrn_fwd_kernel<float><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, c, k,
        alpha, beta, n / 2, beta_is_three_quarters);
  }
  return static_cast<int>(cudaGetLastError());
}
