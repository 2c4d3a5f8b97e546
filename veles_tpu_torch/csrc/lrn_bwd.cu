// Cross-channel local response normalization, backward:
//   dx = g * d^-beta - 2 * alpha * beta * x * W(g * x * d^(-beta-1)),
//   d  = k + alpha * W(x^2),
// with W the n-wide (n odd) channel window [c - n/2, c + n/2], zero outside
// the row, over channels-last rows (R, C). d is recomputed from x: the only
// residual of the forward is x itself.
//
// Replaces the TPU kernel `_bwd_kernel` reached through `_call_bwd` and the
// `custom_vjp` of `lrn_fused` (veles_tpu/ops/lrn.py). It computes the LRN
// gradients of AlexNet's training step: rows B*56*56, C = 96 after conv1
// and rows B*27*27, C = 256 after conv2.
//
// Bound on an H100 SXM (3.35 TB/s): memory. It reads x and g and writes dx,
// R*C values each, and does ~2n + 20 operations per value; at B = 128,
// float32, the conv1 LRN moves 3 x 154 MB (138 us at least) and the conv2
// LRN 3 x 96 MB (86 us).
//
// Design, as lrn_fwd.cu: one warp per row (grid-stride over rows), lanes on
// neighbouring channels so every load and store is coalesced. A row's
// squares and its products t = g * x * d^(-beta-1) are staged in shared
// memory (two C-float slices per warp), so both window sums read shared
// memory and device memory is touched once per value and tensor (the
// second reads of x and g hit L1). d^-beta takes the rsqrt chain for
// beta = 3/4, else exp(-beta * log d).

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

__device__ __forceinline__ float window_sum(const float* v, int ch, int c,
                                            int half) {
  const int lo = max(ch - half, 0);
  const int hi = min(ch + half, c - 1);
  float sum = 0.0f;
  for (int j = lo; j <= hi; ++j) sum += v[j];
  return sum;
}

__device__ __forceinline__ float neg_pow(float d, float beta,
                                         int beta_is_three_quarters) {
  if (beta_is_three_quarters) {
    const float s = rsqrtf(d);  // d^-1/2
    return s * s * rsqrtf(s);   // d^-1 * d^1/4
  }
  return expf(-beta * logf(d));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long rows, int c, float k,
               float alpha, float beta, int half,
               int beta_is_three_quarters) {
  extern __shared__ float staged[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* sq = staged + warp * 2 * c;
  float* t = sq + c;
  const float scale = 2.0f * alpha * beta;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const T* xr = x + row * c;
    const T* gr = g + row * c;
    T* dxr = dx + row * c;
    for (int ch = lane; ch < c; ch += 32) {
      const float v = to_f32(xr[ch]);
      sq[ch] = v * v;
    }
    __syncwarp();
    for (int ch = lane; ch < c; ch += 32) {
      const float d = k + alpha * window_sum(sq, ch, c, half);
      const float q = neg_pow(d, beta, beta_is_three_quarters);
      t[ch] = to_f32(gr[ch]) * to_f32(xr[ch]) * (q / d);
    }
    __syncwarp();
    for (int ch = lane; ch < c; ch += 32) {
      const float d = k + alpha * window_sum(sq, ch, c, half);
      const float q = neg_pow(d, beta, beta_is_three_quarters);
      const float u = window_sum(t, ch, c, half);
      store_out(dxr + ch,
                to_f32(gr[ch]) * q - scale * to_f32(xr[ch]) * u);
    }
    __syncwarp();  // the next row overwrites sq and t
  }
}

}  // namespace

// Shared memory the launch needs for `c` channels (the wrapper checks it
// against the 48 KB a launch may take without opting in).
extern "C" int veles_lrn_bwd_smem_bytes(int c) {
  return kWarps * 2 * c * (int)sizeof(float);
}

// x, g, dx: (rows, c) contiguous, all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1). n must be odd. Returns cudaGetLastError() after the launch.
extern "C" int veles_lrn_bwd(const void* x, const void* g, void* dx,
                             long long rows, int c, float k, float alpha,
                             float beta, int n, int beta_is_three_quarters,
                             int bf16, void* stream) {
  const long long blocks_needed = (rows + kWarps - 1) / kWarps;
  const int blocks = (int)(blocks_needed < (1LL << 30) ? blocks_needed
                                                       : (1LL << 30));
  const size_t smem = (size_t)kWarps * 2 * c * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    lrn_bwd_kernel<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), rows, c, k, alpha, beta, n / 2,
        beta_is_three_quarters);
  } else {
    lrn_bwd_kernel<float><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), rows, c, k, alpha, beta, n / 2,
        beta_is_three_quarters);
  }
  return static_cast<int>(cudaGetLastError());
}
