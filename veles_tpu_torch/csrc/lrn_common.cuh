// Device helpers shared by the LRN kernels, forward (lrn_fwd.cu) and
// backward (lrn_bwd.cu): element conversions, the window sums of the
// shared-memory (general) forms, d^-beta, and the vector forms' 16-byte
// accesses and warp-shuffled window halo.
//
// ops/build.py hashes every csrc/*.cuh into each kernel library's name, so
// an edit here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lrn {

constexpr int kWarps = 8;    // warps of a block, in every form
constexpr int kMaxHalf = 4;  // the vector forms' widest window: n = 9

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The general forms' window sum over a row staged in shared memory.
__device__ __forceinline__ float window_sum(const float* v, int ch, int c,
                                            int half) {
  const int lo = max(ch - half, 0);
  const int hi = min(ch + half, c - 1);
  float sum = 0.0f;
  for (int j = lo; j <= hi; ++j) sum += v[j];
  return sum;
}

// d^-beta: the TPU kernel's rsqrt chain for beta = 3/4
// (rsqrt(d)^2 * rsqrt(rsqrt(d))), else exp(-beta * log d).
__device__ __forceinline__ float neg_pow(float d, float beta,
                                         int beta_is_three_quarters) {
  if (beta_is_three_quarters) {
    const float s = rsqrtf(d);  // d^-1/2
    return s * s * rsqrtf(s);   // d^-1 * d^1/4
  }
  return expf(-beta * logf(d));
}

// 16-byte read-only loads of 4 float32 or 8 bf16 values into float32
// registers (bf16 -> float32 is exact).
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16-byte stores of 4 float32 or 8 bf16 values (rounded to nearest even);
// Streaming: __stcs (evict first), else a plain store.
template <bool Streaming, typename V>
__device__ __forceinline__ void store_vec(V* p, V v) {
  if constexpr (Streaming) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}
template <bool Streaming>
__device__ __forceinline__ void store16(float* p, const float* v) {
  store_vec<Streaming>(reinterpret_cast<float4*>(p),
                       make_float4(v[0], v[1], v[2], v[3]));
}
template <bool Streaming>
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  store_vec<Streaming>(reinterpret_cast<uint4*>(p),
                       make_uint4(w[0], w[1], w[2], w[3]));
}

// e[0, R) the left halo, e[R, R + CPT) this lane's values, then the right
// halo: the neighbouring lanes' values by shuffle, 0 beyond the row. Every
// lane of the warp takes part (R <= CPT).
template <int CPT, int R>
__device__ __forceinline__ void with_halo(const float* own, float* e,
                                          bool left, bool right) {
#pragma unroll
  for (int i = 0; i < CPT; ++i) e[R + i] = own[i];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const float l = __shfl_up_sync(0xffffffffu, own[CPT - 1 - m], 1);
    const float r = __shfl_down_sync(0xffffffffu, own[m], 1);
    e[R - 1 - m] = left ? l : 0.0f;
    e[R + CPT + m] = right ? r : 0.0f;
  }
}

// The window sum at channel i of e: e[R + i - half] + ... + e[R + i + half]
// from the low channel up, as the plain version adds its shifted slices.
// H >= 0: half = H at compile time; H < 0: any half <= R, predicated.
template <int R, int H>
__device__ __forceinline__ float window_at(const float* e, int i, int half) {
  if constexpr (H >= 0) {
    float s = e[R + i - H];
#pragma unroll
    for (int j = -H + 1; j <= H; ++j) s += e[R + i + j];
    return s;
  } else {
    float s = 0.0f;
#pragma unroll
    for (int j = -R; j <= R; ++j)
      if (j >= -half && j <= half) s += e[R + i + j];
    return s;
  }
}

}  // namespace lrn
