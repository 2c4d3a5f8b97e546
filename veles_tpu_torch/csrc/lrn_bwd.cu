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
// and rows B*27*27, C = 256 after conv2, in float32 and bf16.
//
// Bound on an H100 SXM (3.35 TB/s): memory. It reads x and g and writes dx,
// R*C values each, and does ~2n + 20 operations per value (three of them on
// the special-function units); at B = 128 the conv1 LRN moves 3 x 154 MB in
// float32 (138 us at least) and half that in bf16 (69 us).
//
// Two forms, chosen by `lrn_bwd_plan` (ops/lrn.py):
// * vector (the designed form): each thread holds CPT neighbouring channels
//   of a row (4 or 8 float32, 8 or 16 bf16), read through the read-only
//   path (faster than streaming loads in float32 on an H100) and written
//   with 16-byte accesses, x and g read once. A row lies on `lanes`
//   neighbouring lanes of one warp (32 / lanes rows a warp), and the
//   window's halo, n/2 channels each side, comes from the next lanes by
//   __shfl; a halo beyond the row reads 0. d, q = d^-beta and q * (1/d)
//   are computed once for each value (1/d = rsqrt(d)^2 beside the rsqrt
//   chain of q for beta = 3/4), with fused multiply-adds where the
//   formula has a product and a sum, and both window sums run in the
//   plain version's order (low channel first), unrolled at compile time
//   for n = 5 and predicated for any other n up to 9. A grid of up to 16
//   blocks of 8 warps per SM walks the row groups grid-stride, one group
//   a warp at a time: more resident warps, not more rows a warp, keep the
//   loads in flight (two groups a warp in flight were slower in bf16 on
//   an H100). No shared memory, no block barrier.
// * general (the shared-memory kernel): one warp per row, the squares and
//   products staged in shared memory. It takes what the vector form does
//   not: C not a multiple of the vector, a pointer off 16 bytes, rows
//   wider than 32 lanes of CPT, or n > 9.
// d^-beta takes the rsqrt chain for beta = 3/4, else exp(-beta * log d).

#include "lrn_common.cuh"

namespace {

using namespace lrn;

// q = d^-beta and 1/d, each once: for beta = 3/4 both from s = rsqrt(d)
// (q = s^2 rsqrt(s), 1/d = s^2), else exp(-beta log d) and a rounded
// reciprocal.
__device__ __forceinline__ void powers(float d, float beta,
                                       int beta_is_three_quarters, float* q,
                                       float* inv) {
  if (beta_is_three_quarters) {
    const float s = rsqrtf(d);
    const float s2 = s * s;
    *q = s2 * rsqrtf(s);
    *inv = s2;
  } else {
    *q = expf(-beta * logf(d));
    *inv = __frcp_rn(d);
  }
}

template <typename T, int CPT, int H>
__global__ void __launch_bounds__(kWarps * 32)
lrn_bwd_vector(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long rows, int c, int lanes,
               int rows_per_warp, float k, float alpha, float beta,
               int half, int beta_is_three_quarters) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = H >= 0 ? H : kMaxHalf;
  const int lane = threadIdx.x % 32;
  const int sub = lane / lanes;  // the warp's row
  const int pos = lane % lanes;  // the lane's place in the row
  const int c0 = pos * CPT;
  const bool left = pos > 0;
  const bool right = pos < lanes - 1;
  const float scale = 2.0f * alpha * beta;
  const long long groups = (rows + rows_per_warp - 1) / rows_per_warp;
  for (long long group = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       group < groups; group += (long long)gridDim.x * kWarps) {
    const long long row = group * rows_per_warp + sub;
    const bool live = sub < rows_per_warp && row < rows;
    float xv[CPT], gv[CPT];
#pragma unroll
    for (int v = 0; v < CPT / VEC; ++v) {
      const int ch = c0 + v * VEC;
      if (live && ch < c) {
        load16(x + row * c + ch, xv + v * VEC);
        load16(g + row * c + ch, gv + v * VEC);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xv[v * VEC + i] = 0.0f;
          gv[v * VEC + i] = 0.0f;
        }
      }
    }
    float own[CPT], e[CPT + 2 * R], q[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) own[i] = xv[i] * xv[i];
    with_halo<CPT, R>(own, e, left, right);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float d = fmaf(alpha, window_at<R, H>(e, i, half), k);
      float inv;
      powers(d, beta, beta_is_three_quarters, q + i, &inv);
      own[i] = (gv[i] * xv[i]) * (q[i] * inv);
    }
    with_halo<CPT, R>(own, e, left, right);
    float out[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float u = window_at<R, H>(e, i, half);
      out[i] = fmaf(-(scale * xv[i]), u, gv[i] * q[i]);
    }
#pragma unroll
    for (int v = 0; v < CPT / VEC; ++v) {
      const int ch = c0 + v * VEC;
      if (live && ch < c) store16<true>(dx + row * c + ch, out + v * VEC);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lrn_bwd_general(const T* __restrict__ x, const T* __restrict__ g,
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

template <typename T, int CPT>
void launch_vector(const void* x, const void* g, void* dx, long long rows,
                   int c, int lanes, int rows_per_warp, int blocks, float k,
                   float alpha, float beta, int half, int b34,
                   cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  if (half == 2)
    lrn_bwd_vector<T, CPT, 2><<<blocks, kWarps * 32, 0, s>>>(
        xp, gp, dxp, rows, c, lanes, rows_per_warp, k, alpha, beta, half,
        b34);
  else
    lrn_bwd_vector<T, CPT, -1><<<blocks, kWarps * 32, 0, s>>>(
        xp, gp, dxp, rows, c, lanes, rows_per_warp, k, alpha, beta, half,
        b34);
}

}  // namespace

// x, g, dx: (rows, c) contiguous, all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1). n must be odd. The rest is `lrn_bwd_plan`'s: form 0 is the
// vector form (cpt channels a lane, `lanes` lanes a row, rows_per_warp
// rows a warp, `blocks` blocks; c % (16 / element size) == 0, every
// pointer 16-byte aligned, n <= 9), form 1 the general one (`blocks`
// blocks, 2 * 8 * c * 4 bytes of shared memory, at most 48 KB). Returns
// cudaGetLastError() after the launch.
extern "C" int veles_lrn_bwd(const void* x, const void* g, void* dx,
                             long long rows, int c, float k, float alpha,
                             float beta, int n, int beta_is_three_quarters,
                             int bf16, int form, int cpt, int lanes,
                             int rows_per_warp, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = n / 2;
  const int b34 = beta_is_three_quarters;
  if (form == 0) {
    if (bf16) {
      if (cpt == 8)
        launch_vector<__nv_bfloat16, 8>(x, g, dx, rows, c, lanes,
                                        rows_per_warp, blocks, k, alpha,
                                        beta, half, b34, s);
      else
        launch_vector<__nv_bfloat16, 16>(x, g, dx, rows, c, lanes,
                                         rows_per_warp, blocks, k, alpha,
                                         beta, half, b34, s);
    } else {
      if (cpt == 4)
        launch_vector<float, 4>(x, g, dx, rows, c, lanes, rows_per_warp,
                                blocks, k, alpha, beta, half, b34, s);
      else
        launch_vector<float, 8>(x, g, dx, rows, c, lanes, rows_per_warp,
                                blocks, k, alpha, beta, half, b34, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (size_t)kWarps * 2 * c * sizeof(float);
  if (bf16) {
    lrn_bwd_general<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), rows, c, k, alpha, beta, half, b34);
  } else {
    lrn_bwd_general<float><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), rows, c, k, alpha, beta, half, b34);
  }
  return static_cast<int>(cudaGetLastError());
}
