// Cross-channel local response normalization, forward:
//   y = x * (k + alpha * W(x^2))^-beta
// with W the n-wide (n odd) channel window [c - n/2, c + n/2], zero outside
// the row, over channels-last rows (R, C), float32 math.
//
// Replaces the TPU kernel `_fwd_kernel` reached through `_call_fwd` and
// `lrn_fused` (veles_tpu/ops/lrn.py). It computes the LRN after AlexNet's
// conv1 (rows B*56*56, C = 96) and conv2 (rows B*27*27, C = 256), twice in
// every forward of serving and training.
//
// Bound on an H100 SXM (3.35 TB/s): memory. It reads R*C values and writes
// R*C values and does ~n + 7 operations per value (one of them on the
// special-function units), far below the card's operations-per-byte
// balance. At B = 128 the conv1 LRN moves 2 x 154 MB in float32 (92 us at
// least) and half that in bf16 (46 us); conv2 2 x 96 MB (57 us, 29 us).
//
// Two forms, chosen by `lrn_fwd_plan` (ops/lrn.py):
// * vector (the designed form): each lane holds CPT neighbouring channels
//   of a row (4-24 float32, 8-24 bf16: whole 16-byte vectors), read once
//   through the read-only path and written with 16-byte plain stores. A
//   row lies on `lanes` neighbouring lanes of one warp, 32 / lanes rows a
//   warp. The plan gives a lane two vectors (32 bytes) where a row allows:
//   C = 96 float32 is 8 channels on 12 lanes, 2 rows a warp (on an H100
//   7% faster than 12 channels on 8 lanes, which fill all 32 lanes, and
//   than 4 on 24). The window's halo, n/2 squares each side, comes from
//   the next lanes by __shfl and reads 0 beyond the row. d = fma(alpha, W,
//   k), the window summed low channel first, unrolled at compile time for
//   n = 5 and predicated for any other n up to 9. No shared memory, no
//   barrier. A grid of at most 16 blocks of 8 warps an SM walks the row
//   groups grid-stride, one group a warp at a time (2, 4 and 8 blocks an
//   SM were no faster).
// * general (the shared-memory kernel): one warp per row, the squares in
//   shared memory, scalar accesses. It takes what the vector form does not:
//   C not a multiple of the vector, a pointer off 16 bytes, rows wider than
//   32 lanes of CPT, or n > 9.
// d^-beta takes the rsqrt chain for beta = 3/4, else exp(-beta * log d).
//
// The vector form's stores: VELES_LRN_FWD_STREAMING_STORES 0 (the default)
// stores plainly, 1 with __stcs (evict first). Plain stores were as fast or
// faster at every training shape on an H100, up to 11% at C = 256 float32
// (PERF.md; scripts/probe_k3_k7.py builds both), and y is read by the
// max-pool right after.

#include "lrn_common.cuh"

#ifndef VELES_LRN_FWD_STREAMING_STORES
#define VELES_LRN_FWD_STREAMING_STORES 0
#endif

namespace {

using namespace lrn;

constexpr bool kStreamingStores = VELES_LRN_FWD_STREAMING_STORES != 0;

template <typename T, int CPT, int H>
__global__ void __launch_bounds__(kWarps * 32)
lrn_fwd_vector(const T* __restrict__ x, T* __restrict__ y, long long rows,
               int c, int lanes, int rows_per_warp, float k, float alpha,
               float beta, int half, int beta_is_three_quarters) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = H >= 0 ? H : kMaxHalf;
  const int lane = threadIdx.x % 32;
  const int sub = lane / lanes;  // the warp's row
  const int pos = lane % lanes;  // the lane's place in the row
  const int c0 = pos * CPT;
  const bool left = pos > 0;
  const bool right = pos < lanes - 1;
  const long long groups = (rows + rows_per_warp - 1) / rows_per_warp;
  for (long long group = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       group < groups; group += (long long)gridDim.x * kWarps) {
    const long long row = group * rows_per_warp + sub;
    const bool live = sub < rows_per_warp && row < rows;
    float xv[CPT];
#pragma unroll
    for (int v = 0; v < CPT / VEC; ++v) {
      const int ch = c0 + v * VEC;
      if (live && ch < c) {
        load16(x + row * c + ch, xv + v * VEC);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[v * VEC + i] = 0.0f;
      }
    }
    float sq[CPT], e[CPT + 2 * R], out[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) sq[i] = xv[i] * xv[i];
    with_halo<CPT, R>(sq, e, left, right);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float d = fmaf(alpha, window_at<R, H>(e, i, half), k);
      out[i] = xv[i] * neg_pow(d, beta, beta_is_three_quarters);
    }
#pragma unroll
    for (int v = 0; v < CPT / VEC; ++v) {
      const int ch = c0 + v * VEC;
      if (live && ch < c)
        store16<kStreamingStores>(y + row * c + ch, out + v * VEC);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lrn_fwd_general(const T* __restrict__ x, T* __restrict__ y, long long rows,
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
      const float d = k + alpha * window_sum(sq, ch, c, half);
      store_out(yr + ch,
                to_f32(xr[ch]) * neg_pow(d, beta, beta_is_three_quarters));
    }
    __syncwarp();  // the next row overwrites sq
  }
}

template <typename T, int CPT>
void launch_vector(const void* x, void* y, long long rows, int c, int lanes,
                   int rows_per_warp, int blocks, float k, float alpha,
                   float beta, int half, int b34, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (half == 2)
    lrn_fwd_vector<T, CPT, 2><<<blocks, kWarps * 32, 0, s>>>(
        xp, yp, rows, c, lanes, rows_per_warp, k, alpha, beta, half, b34);
  else
    lrn_fwd_vector<T, CPT, -1><<<blocks, kWarps * 32, 0, s>>>(
        xp, yp, rows, c, lanes, rows_per_warp, k, alpha, beta, half, b34);
}

// The vector form at `cpt` channels a lane; false for a cpt it has no
// instance of (float32 4, 8, 12, 16, 24; bf16 8, 16, 24).
bool vector_form(int bf16, int cpt, const void* x, void* y, long long rows,
                 int c, int lanes, int rows_per_warp, int blocks, float k,
                 float alpha, float beta, int half, int b34,
                 cudaStream_t s) {
#define VELES_LRN_FWD_CASE(T, CPT)                                          \
  case CPT:                                                                 \
    launch_vector<T, CPT>(x, y, rows, c, lanes, rows_per_warp, blocks, k,   \
                          alpha, beta, half, b34, s);                       \
    return true;
  if (bf16) {
    switch (cpt) {
      VELES_LRN_FWD_CASE(__nv_bfloat16, 8)
      VELES_LRN_FWD_CASE(__nv_bfloat16, 16)
      VELES_LRN_FWD_CASE(__nv_bfloat16, 24)
    }
  } else {
    switch (cpt) {
      VELES_LRN_FWD_CASE(float, 4)
      VELES_LRN_FWD_CASE(float, 8)
      VELES_LRN_FWD_CASE(float, 12)
      VELES_LRN_FWD_CASE(float, 16)
      VELES_LRN_FWD_CASE(float, 24)
    }
  }
#undef VELES_LRN_FWD_CASE
  return false;
}

}  // namespace

// x, y: (rows, c) contiguous, both float32 (bf16 = 0) or both bfloat16
// (bf16 = 1). n must be odd. The rest is `lrn_fwd_plan`'s: form 0 is the
// vector form (cpt channels a lane, `lanes` lanes a row, rows_per_warp rows
// a warp, `blocks` blocks; c % (16 / element size) == 0, both pointers
// 16-byte aligned, n <= 9), form 1 the general one (`blocks` blocks,
// 8 * c * 4 bytes of shared memory, at most 48 KB). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a cpt the
// vector form has no instance of.
extern "C" int veles_lrn_fwd(const void* x, void* y, long long rows, int c,
                             float k, float alpha, float beta, int n,
                             int beta_is_three_quarters, int bf16, int form,
                             int cpt, int lanes, int rows_per_warp,
                             int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = n / 2;
  const int b34 = beta_is_three_quarters;
  if (form == 0) {
    if (!vector_form(bf16, cpt, x, y, rows, c, lanes, rows_per_warp, blocks,
                     k, alpha, beta, half, b34, s))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (size_t)kWarps * c * sizeof(float);
  if (bf16) {
    lrn_fwd_general<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        rows, c, k, alpha, beta, half, b34);
  } else {
    lrn_fwd_general<float><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, c, k,
        alpha, beta, half, b34);
  }
  return static_cast<int>(cudaGetLastError());
}
