// act(x @ w + bias) for Hopper: four variants of one function, chosen by
// shape and dtype in veles_tpu_torch/ops/gemm.py:gemm_plan.
//
// Replaces the TPU kernel `_gemm_bias_kernel` reached through
// `pallas_gemm(..., bias=...)` and `fused_linear` (veles_tpu/ops/gemm.py),
// and with bias == nullptr its no-bias twin `_gemm_kernel`. It computes the
// All2All forward of fc6 and fc7 and the K2 products of the GEMM-disciplines
// bench. x (M, K) and w (K, N) are row-major, both float32 or both bfloat16;
// the product accumulates in float32, the bias is float32, the epilogue runs
// in float32 and rounds once to a float32 or bfloat16 output.
//
// Bounds on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on the CUDA cores,
// 989 TFLOP/s bf16 on the tensor cores) and the design of each variant:
//
// 1. stream (M <= 32 float32, M <= 16 bf16: serving). Bound by reading w
//    once: fc6 is 151 MB in float32 (45 us), fc7 67 MB (20 us). K is split
//    over ~4 blocks per SM (fc6 float32: 32 column blocks x 16 K splits).
//    A block stages its rows of x (as float32) in shared memory, and each
//    warp streams rows of its K slab of w with 16-byte loads along N
//    (neighbouring lanes on neighbouring addresses), 8 rows in flight per
//    thread, keeping M x (4 or 8) sums in registers. The 8 warps' sums are
//    added in shared memory in a fixed order.
// 2. tiles (float32, M > 32: serving M = 64, training float32 M = 128, the
//    disciplines shapes). Bound by float32 operations on the CUDA cores
//    (fc6 at M = 128: 0.144 ms). 128x128 output tiles (64x128 for M <= 64
//    or K <= 256), 8x8 (4x8) outputs a thread, 16-deep K steps double-
//    buffered in shared memory: w by 16-byte cp.async copies, x through
//    registers (16 bytes along K of a row) stored transposed, so that every
//    thread reads both operands as float4 and the next step's loads fly
//    while this one's FMAs run. Two blocks an SM (three at 64 rows). Full
//    float32, no TF32.
// 3. tensor_core (bf16, M > 16: training bf16 M = 128). Bound by reading w
//    (fc6 75.5 MB, 23.6 us). 128x128 tiles, 64-deep K steps: one producer
//    warp keeps a 4-stage ring of TMA loads (128-byte swizzle) in flight,
//    guarded by mbarriers; two consumer warpgroups run wgmma m64n64k16 with
//    x K-major and w MN-major (the descriptor's transpose bit, so w is never
//    transposed in memory), accumulating in float32 registers.
// 4. general: the masked kernel of the port's first slice, for shapes the
//    three forms cannot take (rows or base pointers not 16-byte aligned).
//    BN = 32 columns, 16 or 64 rows; any M, N, K.
//
// Forms 1-3 split K where the tile grid alone leaves SMs idle or ends in a
// ragged wave (the plan's choice; the kernels take any split). Each split
// writes its float32 partial sums to its own plane of a workspace, and a
// second pass adds the planes in split order, adds the bias once and applies
// the epilogue. With one split the first pass applies the epilogue to its
// registers and writes the output itself. No float atomics: two calls give
// bitwise-equal outputs. One C entry launches both passes.

#include <cuda.h>  // CUtensorMap and its enums only: the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

enum Form { kGeneral = 0, kStream = 1, kTiles = 2, kTensorCore = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The five epilogues of veles_tpu/ops/gemm.py with their exact constants.
__device__ __forceinline__ float epilogue(float x, int act) {
  switch (act) {
    case 1:  // LeCun-scaled tanh
      return 1.7159f * tanhf(0.6666f * x);
    case 2:  // sigmoid
      return 1.0f / (1.0f + expf(-x));
    case 3:  // softplus "relu", linear above 15
      return x > 15.0f ? x : log1pf(expf(fminf(x, 15.0f)));
    case 4:  // strict relu
      return fmaxf(x, 0.0f);
    default:  // linear
      return x;
  }
}

// out[i] = act(v + bias[c]): the bias added once, then the epilogue.
template <typename TOut>
__device__ __forceinline__ void finish(TOut* out, const float* bias,
                                       size_t i, int c, float v, int act) {
  if (bias != nullptr) v += bias[c];
  store_out(out + i, epilogue(v, act));
}

// four outputs in one store: 16 bytes of float32 or 8 of bf16
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 bits;
  bits.x = *reinterpret_cast<const uint32_t*>(&lo);
  bits.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}

// Four neighbouring outputs (r, c ... c + 3), c % 4 == n % 4 == 0: to this
// split's partial plane when there is one, else through the epilogue to
// the output.
template <typename TOut>
__device__ __forceinline__ void emit4(TOut* out, float* part,
                                      const float* bias, int r, int c, int n,
                                      float4 s, int act) {
  const size_t i = (size_t)r * n + c;
  if (part != nullptr) {
    *reinterpret_cast<float4*>(part + i) = s;
    return;
  }
  if (bias != nullptr) {
    const float4 bv = *reinterpret_cast<const float4*>(bias + c);
    s.x += bv.x;
    s.y += bv.y;
    s.z += bv.z;
    s.w += bv.w;
  }
  store4(out + i, make_float4(epilogue(s.x, act), epilogue(s.y, act),
                              epilogue(s.z, act), epilogue(s.w, act)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- second pass: the K splits' partials summed in split order --------------

constexpr int kReduceThreads = 256;

template <typename TOut>
__global__ void __launch_bounds__(kReduceThreads)
gemm_bias_act_reduce(const float* __restrict__ ws,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     int m, int n, int splits, int act) {
  const size_t plane = (size_t)m * n;
  const size_t quads = plane / 4;  // every split form has n % 4 == 0
  for (size_t q = blockIdx.x * (size_t)blockDim.x + threadIdx.x; q < quads;
       q += (size_t)gridDim.x * blockDim.x) {
    float4 s = __ldcs(reinterpret_cast<const float4*>(ws) + q);
    for (int p = 1; p < splits; ++p) {
      const float4 v =
          __ldcs(reinterpret_cast<const float4*>(ws + p * plane) + q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const size_t i = q * 4;
    emit4<TOut>(out, nullptr, bias, (int)(i / n), (int)(i % n), n, s, act);
  }
}

// -- 1. stream: split-K weight streaming for small M -----------------------

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamRows = 8;  // rows of w a thread loads before it multiplies
constexpr int kStreamSmem = 98304;  // the plan keeps x's slab within 96 KB

// 16 bytes of w as floats: 4 float32 or 8 bf16 (bf16 -> float32 is exact:
// the bits shifted up; element 0 is the low half).
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename TIn, typename TOut, int MB>
__global__ void __launch_bounds__(kStreamThreads)
gemm_bias_act_stream(const TIn* __restrict__ a, const TIn* __restrict__ b,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     float* __restrict__ ws, int m, int n, int k, int kchunk,
                     int act) {
  constexpr int CPT = 16 / sizeof(TIn);  // columns a thread owns
  constexpr int BN = 32 * CPT;           // a warp spans the block's columns
  constexpr int RC = MB < 8 ? MB : 8;    // rows per shared-memory reduction
  extern __shared__ float4 stream_smem[];
  float* xs = reinterpret_cast<float*>(stream_smem);  // [MB][kchunk]
  const int k0 = blockIdx.y * kchunk;
  const int kn = min(kchunk, k - k0);
  for (int i = threadIdx.x; i < MB * kchunk; i += kStreamThreads) {
    const int r = i / kchunk, kk = i - r * kchunk;
    xs[i] = (r < m && kk < kn) ? to_f32(a[(size_t)r * k + k0 + kk]) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * BN + lane * CPT;  // n % CPT == 0
  float acc[MB][CPT];
#pragma unroll
  for (int r = 0; r < MB; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;
  if (c0 < n) {
    const size_t pitch = n / CPT;  // 16-byte words per row of w
    const uint4* bp =
        reinterpret_cast<const uint4*>(b + (size_t)k0 * n + c0);
    for (int g = warp * kStreamRows; g < kn;
         g += kStreamWarps * kStreamRows) {
      uint4 raw[kStreamRows];
#pragma unroll
      for (int u = 0; u < kStreamRows; ++u)
        raw[u] = g + u < kn ? __ldcs(bp + (size_t)(g + u) * pitch)
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int h = 0; h < kStreamRows; h += 4) {
        float wv[4][CPT];
#pragma unroll
        for (int u = 0; u < 4; ++u) unpack(raw[h + u], wv[u]);
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + r * kchunk + g + h);
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            float s = acc[r][j];
            s = fmaf(xv.x, wv[0][j], s);
            s = fmaf(xv.y, wv[1][j], s);
            s = fmaf(xv.z, wv[2][j], s);
            acc[r][j] = fmaf(xv.w, wv[3][j], s);
          }
        }
      }
    }
  }
  __syncthreads();  // x's slab is free: it becomes the reduction buffer

  float* red = xs;  // [warp][RC][BN]
  float* part = ws == nullptr ? nullptr : ws + blockIdx.y * (size_t)m * n;
#pragma unroll
  for (int r0 = 0; r0 < MB; r0 += RC) {
    if (c0 < n) {
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < CPT; j += 4)
          *reinterpret_cast<float4*>(red + (warp * RC + i) * BN + lane * CPT +
                                     j) =
              make_float4(acc[r0 + i][j], acc[r0 + i][j + 1],
                          acc[r0 + i][j + 2], acc[r0 + i][j + 3]);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < RC * BN / 4; q += kStreamThreads) {
      const int i = q / (BN / 4), c = (q % (BN / 4)) * 4;
      float4 s = *reinterpret_cast<const float4*>(red + i * BN + c);
      for (int w = 1; w < kStreamWarps; ++w) {
        const float4 v =
            *reinterpret_cast<const float4*>(red + (w * RC + i) * BN + c);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const int r = r0 + i, gc = blockIdx.x * BN + c;
      if (r < m && gc < n) emit4<TOut>(out, part, bias, r, gc, n, s, act);
    }
    __syncthreads();
  }
}

// -- 2. tiles: register-blocked float32 tiles --------------------------------

constexpr int kTileThreads = 256;  // 16 x 16
constexpr int kTileBN = 128;
constexpr int kTileBK = 16;
constexpr int kTilePad = 4;  // x's K-major rows: 16-byte aligned, 2-way stores

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  // src-size 0 fills the 16 bytes with zeros (ragged M, N and K edges)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two stages of x (K-major, [BK][BM + pad]) and w ([BK][BN])
template <int BM>
constexpr int tile_smem() {
  return 2 * (kTileBK * (BM + kTilePad) + kTileBK * kTileBN) * 4;
}

// thread (ty, tx) owns rows h * 64 + ty * 4 + {0..3} (h < BM / 64) and
// columns h' * 64 + tx * 4 + {0..3} (h' < 2)
__device__ __forceinline__ int tile_row(int i, int ty) {
  return (i / 4) * 64 + ty * 4 + (i % 4);
}

// blocks an SM holds: 128-row tiles need ~128 registers a thread, 64-row
// tiles fit three blocks
template <typename TOut, int BM>
__global__ void __launch_bounds__(kTileThreads, BM == 64 ? 3 : 2)
gemm_bias_act_tiles(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, TOut* __restrict__ out,
                    float* __restrict__ ws, int m, int n, int k, int kchunk,
                    int act) {
  constexpr int TM = BM / 16;
  constexpr int AP = BM + kTilePad;          // pitch of a K row of x
  constexpr int A_LOADS = BM * kTileBK / 4 / kTileThreads;  // float4 each
  constexpr int B_LOADS = kTileBK * kTileBN / 4 / kTileThreads;
  constexpr int STAGE = kTileBK * AP + kTileBK * kTileBN;
  extern __shared__ float4 tile_smem4[];
  float* sm = reinterpret_cast<float*>(tile_smem4);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kTileBN;
  const int k0 = blockIdx.z * kchunk;
  const int kend = min(k, k0 + kchunk);  // k % 4 == kchunk % 4 == 0
  const int steps = (kend - k0 + kTileBK - 1) / kTileBK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // x goes through registers (16 bytes along K from each of its rows)
  // and is stored transposed, so that a thread reads its rows as float4;
  // w goes straight to shared memory by cp.async
  float4 xa[A_LOADS];
  auto load_x = [&](int t) {
    const int kt = k0 + t * kTileBK;
#pragma unroll
    for (int l = 0; l < A_LOADS; ++l) {
      const int i = threadIdx.x + l * kTileThreads;
      const int r = i / (kTileBK / 4), gk = kt + (i % (kTileBK / 4)) * 4;
      xa[l] = row0 + r < m && gk < kend
                  ? __ldg(reinterpret_cast<const float4*>(
                        a + (size_t)(row0 + r) * k + gk))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store_x = [&](int stage) {
    float* as = sm + stage * STAGE;
#pragma unroll
    for (int l = 0; l < A_LOADS; ++l) {
      const int i = threadIdx.x + l * kTileThreads;
      const int r = i / (kTileBK / 4), kq = (i % (kTileBK / 4)) * 4;
      as[(kq + 0) * AP + r] = xa[l].x;
      as[(kq + 1) * AP + r] = xa[l].y;
      as[(kq + 2) * AP + r] = xa[l].z;
      as[(kq + 3) * AP + r] = xa[l].w;
    }
  };
  auto load_w = [&](int stage, int t) {
    const int kt = k0 + t * kTileBK;
    float* bs = sm + stage * STAGE + kTileBK * AP;
#pragma unroll
    for (int l = 0; l < B_LOADS; ++l) {
      const int i = threadIdx.x + l * kTileThreads;
      const int r = i / (kTileBN / 4), q = i % (kTileBN / 4);
      const int gk = kt + r, gc = col0 + q * 4;
      const bool ok = gk < kend && gc < n;
      cp_async16(bs + r * kTileBN + q * 4, ok ? b + (size_t)gk * n + gc : b,
                 ok);
    }
    cp_async_commit();
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (steps > 0) {
    load_x(0);
    load_w(0, 0);
    store_x(0);
    cp_async_wait0();
    __syncthreads();
  }
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < steps;
    if (more) {  // step t + 1 in flight while step t is computed
      load_x(t + 1);
      load_w(cur ^ 1, t + 1);
    }
    const float* as = sm + cur * STAGE;
    const float* bs = as + kTileBK * AP;
#pragma unroll
    for (int kk = 0; kk < kTileBK; ++kk) {
      float av[TM];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + kk * AP + h * 64 + ty * 4);
        av[4 * h] = v.x;
        av[4 * h + 1] = v.y;
        av[4 * h + 2] = v.z;
        av[4 * h + 3] = v.w;
      }
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + kk * kTileBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * kTileBN + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(av[i], b0.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b0.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b0.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b0.w, acc[i][3]);
        acc[i][4] = fmaf(av[i], b1.x, acc[i][4]);
        acc[i][5] = fmaf(av[i], b1.y, acc[i][5]);
        acc[i][6] = fmaf(av[i], b1.z, acc[i][6]);
        acc[i][7] = fmaf(av[i], b1.w, acc[i][7]);
      }
    }
    if (more) store_x(cur ^ 1);  // its last readers synced after step t - 1
    cp_async_wait0();
    __syncthreads();
  }

  float* part = ws == nullptr ? nullptr : ws + blockIdx.z * (size_t)m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tile_row(i, ty);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c < n)
        emit4<TOut>(out, part, bias, r, c, n,
                    make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                acc[i][4 * h + 2], acc[i][4 * h + 3]),
                    act);
    }
  }
}

// -- 3. tensor_core: TMA ring + wgmma, bf16 operands ------------------------

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 64, kTcStages = 4;
constexpr int kTcBoxes = kTcBN / 64;  // 64-column boxes of w a stage
constexpr int kTcConsumers = 256;  // two warpgroups, 64 rows each
constexpr int kTcThreads = kTcConsumers + 32;  // + one producer warp
constexpr int kTcABytes = kTcBM * kTcBK * 2;        // 16 KB
constexpr int kTcBoxBytes = kTcBK * 64 * 2;          // 64 rows x 128 B
constexpr int kTcStageBytes = kTcABytes + kTcBoxes * kTcBoxBytes;
constexpr int kTcSmem = kTcStages * kTcStageBytes + 1024;  // + alignment

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. For x (K-major) the
// stride between 8-row groups is 1024 B and the leading offset is unused;
// for a 64-column box of w (MN-major) the stride between 8-row K groups is
// 1024 B and a 64-wide instruction stays inside one swizzle atom along N,
// so both offsets are set to 1024 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  const uint64_t enc = (1024u >> 4) & 0x3FFF;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (enc << 16) | (enc << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, float32) += a (64 x 16, K-major) @ b (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <typename TOut>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_bias_act_tc(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ bias, TOut* __restrict__ out,
                 float* __restrict__ ws, int m, int n, int k, int kchunk,
                 int act) {
  extern __shared__ uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t full[kTcStages], empty[kTcStages];
  // the 128-byte swizzle repeats every 1024 B: stages start on that grid
  const uint32_t base = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const int row0 = blockIdx.y * kTcBM, col0 = blockIdx.x * kTcBN;
  const int kfirst = blockIdx.z * kchunk;  // kchunk % kTcBK == 0
  const int steps = (min(kchunk, k - kfirst) + kTcBK - 1) / kTcBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {  // the producer warp
    if (threadIdx.x == kTcConsumers) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kTcStages;
        mbar_wait(&empty[s], ((t / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kTcStageBytes);
        const uint32_t st = base + s * kTcStageBytes;
        const int kc = kfirst + t * kTcBK;
        tma_load(st, &map_a, kc, row0, &full[s]);
#pragma unroll
        for (int box = 0; box < kTcBoxes; ++box)
          tma_load(st + kTcABytes + box * kTcBoxBytes, &map_b,
                   col0 + 64 * box, kc, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;  // rows wg * 64 ... of the tile
  float d[kTcBoxes][32];            // columns 64 box ... 64 box + 63
#pragma unroll
  for (int box = 0; box < kTcBoxes; ++box)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[box][i] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const int s = t % kTcStages;
    mbar_wait(&full[s], (t / kTcStages) & 1);
    const uint32_t st = base + s * kTcStageBytes;
    const uint32_t a_s = st + wg * 64 * 128;  // 64 rows of 128 B
    const uint32_t b_s = st + kTcABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // x: 16 K values are 32 B along the swizzled row; w: 16 K rows
      const uint64_t da = sw128_desc(a_s + kk * 32);
#pragma unroll
      for (int box = 0; box < kTcBoxes; ++box)
        wgmma_m64n64k16(d[box], da,
                        sw128_desc(b_s + box * kTcBoxBytes + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(&empty[s]);
  }

  // accumulator layout of m64nNk16: register 4j + 2h + c holds row
  // 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + c. n % 8 == 0,
  // so a pair (c = 0, 1) is in bounds together and 8-byte aligned.
  float* part = ws == nullptr ? nullptr : ws + blockIdx.z * (size_t)m * n;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int box = 0; box < kTcBoxes; ++box) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + box * 64 + 8 * j + 2 * (lane % 4);
        if (col >= n) continue;
        const float v0 = d[box][4 * j + 2 * h], v1 = d[box][4 * j + 2 * h + 1];
        const size_t i = (size_t)r * n + col;
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + i) = make_float2(v0, v1);
        } else {
          finish(out, bias, i, col, v0, act);
          finish(out, bias, i + 1, col + 1, v1, act);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a row-major bf16 (outer, inner) matrix read in boxes of (box_outer,
// box_inner = 64) with the 128-byte swizzle; out of bounds reads as zero
bool bf16_map(CUtensorMap* map, const void* ptr, int inner, int outer,
              int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -- 4. general: the masked kernel for unaligned shapes --------------------

constexpr int kThreads = 256;
constexpr int kTX = 16;               // threads along N, 2 columns each
constexpr int kTY = kThreads / kTX;   // threads along M, TM rows each
constexpr int kBN = 2 * kTX;
constexpr int kBK = 32;

template <typename TIn, typename TOut, int TM>
__global__ void __launch_bounds__(kThreads)
gemm_bias_act_general(const TIn* __restrict__ a, const TIn* __restrict__ b,
                      const float* __restrict__ bias, TOut* __restrict__ out,
                      int m, int n, int k, int act) {
  constexpr int BM = kTY * TM;
  // a tile kept K-major (odd row pitch: no bank conflicts on the store)
  __shared__ float as[kBK][BM + 1];
  __shared__ float bs[kBK][kBN];
  static_assert(BM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
                "tile loads must split evenly over the block");
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  float acc[TM][2];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < BM * kBK / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kBK, kk = i % kBK;  // neighbours read along K
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_f32(a[(size_t)gr * k + gk]) : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int kk = i / kBN, c = i % kBN;  // neighbours read along N
      const int gk = k0 + kk, gc = col0 + c;
      bs[kk][c] = (gk < k && gc < n) ? to_f32(b[(size_t)gk * n + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float b0 = bs[kk][tx];
      const float b1 = bs[kk][tx + kTX];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = as[kk][ty + i * kTY];
        acc[i][0] = fmaf(av, b0, acc[i][0]);
        acc[i][1] = fmaf(av, b1, acc[i][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * kTY;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + tx + j * kTX;
      if (c < n) finish(out, bias, (size_t)r * n + c, c, acc[i][j], act);
    }
  }
}

// -- launches ---------------------------------------------------------------

// raise a kernel's dynamic shared-memory limit once
template <typename Kernel>
void allow_smem(Kernel kernel, int bytes, bool* done) {
  if (!*done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    *done = true;
  }
}

struct Call {
  const void* a;
  const void* b;
  const float* bias;
  void* out;
  float* ws;  // null with one split
  int m, n, k, act, tile, splits, kchunk;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, int MB>
int launch_stream_mb(const Call& c) {
  constexpr int CPT = 16 / sizeof(TIn), BN = 32 * CPT, RC = MB < 8 ? MB : 8;
  const int x_bytes = MB * c.kchunk * 4;
  const int red_bytes = kStreamWarps * RC * BN * 4;
  const int smem = x_bytes > red_bytes ? x_bytes : red_bytes;
  if (smem > kStreamSmem || c.kchunk % 8 != 0 || c.m > MB || c.n % CPT != 0)
    return cudaErrorInvalidValue;
  static bool done = false;
  allow_smem(gemm_bias_act_stream<TIn, TOut, MB>, kStreamSmem, &done);
  const dim3 grid((c.n + BN - 1) / BN, c.splits);
  gemm_bias_act_stream<TIn, TOut, MB><<<grid, kStreamThreads, smem,
                                        c.stream>>>(
      static_cast<const TIn*>(c.a), static_cast<const TIn*>(c.b), c.bias,
      static_cast<TOut*>(c.out), c.ws, c.m, c.n, c.k, c.kchunk, c.act);
  return 0;
}

template <typename TIn, typename TOut>
int launch_stream(const Call& c) {
  switch (c.tile) {
    case 1: return launch_stream_mb<TIn, TOut, 1>(c);
    case 2: return launch_stream_mb<TIn, TOut, 2>(c);
    case 4: return launch_stream_mb<TIn, TOut, 4>(c);
    case 8: return launch_stream_mb<TIn, TOut, 8>(c);
    case 16: return launch_stream_mb<TIn, TOut, 16>(c);
    case 32:  // float32 only: 8 bf16 columns x 32 rows is too many registers
      if (sizeof(TIn) == 4) return launch_stream_mb<float, TOut, 32>(c);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename TOut, int BM>
int launch_tiles_bm(const Call& c) {
  if (c.kchunk % kTileBK != 0 || c.k % 4 != 0) return cudaErrorInvalidValue;
  static bool done = false;
  allow_smem(gemm_bias_act_tiles<TOut, BM>, tile_smem<BM>(), &done);
  const dim3 grid((c.n + kTileBN - 1) / kTileBN, (c.m + BM - 1) / BM,
                  c.splits);
  gemm_bias_act_tiles<TOut, BM><<<grid, kTileThreads, tile_smem<BM>(),
                                  c.stream>>>(
      static_cast<const float*>(c.a), static_cast<const float*>(c.b), c.bias,
      static_cast<TOut*>(c.out), c.ws, c.m, c.n, c.k, c.kchunk, c.act);
  return 0;
}

template <typename TOut>
int launch_tc(const Call& c) {
  CUtensorMap map_a, map_b;
  if (c.kchunk % kTcBK != 0 || c.tile != kTcBM ||
      !bf16_map(&map_a, c.a, c.k, c.m, kTcBM) ||
      !bf16_map(&map_b, c.b, c.n, c.k, kTcBK))
    return cudaErrorInvalidValue;
  static bool done = false;
  allow_smem(gemm_bias_act_tc<TOut>, kTcSmem, &done);
  const dim3 grid((c.n + kTcBN - 1) / kTcBN, (c.m + kTcBM - 1) / kTcBM,
                  c.splits);
  gemm_bias_act_tc<TOut><<<grid, kTcThreads, kTcSmem, c.stream>>>(
      map_a, map_b, c.bias, static_cast<TOut*>(c.out), c.ws, c.m, c.n, c.k,
      c.kchunk, c.act);
  return 0;
}

template <typename TIn, typename TOut>
int launch_general(const Call& c) {
  const dim3 block(kThreads);
  if (c.m <= kTY) {
    const dim3 grid((c.n + kBN - 1) / kBN, (c.m + kTY - 1) / kTY);
    gemm_bias_act_general<TIn, TOut, 1><<<grid, block, 0, c.stream>>>(
        static_cast<const TIn*>(c.a), static_cast<const TIn*>(c.b), c.bias,
        static_cast<TOut*>(c.out), c.m, c.n, c.k, c.act);
  } else {
    const int bm = 4 * kTY;
    const dim3 grid((c.n + kBN - 1) / kBN, (c.m + bm - 1) / bm);
    gemm_bias_act_general<TIn, TOut, 4><<<grid, block, 0, c.stream>>>(
        static_cast<const TIn*>(c.a), static_cast<const TIn*>(c.b), c.bias,
        static_cast<TOut*>(c.out), c.m, c.n, c.k, c.act);
  }
  return 0;
}

template <typename TOut>
int launch_form(const Call& c, int form, bool in_bf16) {
  switch (form) {
    case kGeneral:
      return in_bf16 ? launch_general<__nv_bfloat16, TOut>(c)
                     : launch_general<float, TOut>(c);
    case kStream:
      return in_bf16 ? launch_stream<__nv_bfloat16, TOut>(c)
                     : launch_stream<float, TOut>(c);
    case kTiles:
      if (in_bf16) return cudaErrorInvalidValue;
      if (c.tile == 64) return launch_tiles_bm<TOut, 64>(c);
      if (c.tile == 128) return launch_tiles_bm<TOut, 128>(c);
      return cudaErrorInvalidValue;
    case kTensorCore:
      return in_bf16 ? launch_tc<TOut>(c) : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TOut>
void launch_reduce(const Call& c) {
  const long long quads = (long long)c.m * c.n / 4;
  long long blocks = (quads + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 2048) blocks = 2048;
  gemm_bias_act_reduce<TOut><<<(int)blocks, kReduceThreads, 0, c.stream>>>(
      c.ws, c.bias, static_cast<TOut*>(c.out), c.m, c.n, c.splits, c.act);
}

}  // namespace

// act(a @ b + bias) in one call: the first pass in the variant `form`
// (0 general, 1 stream, 2 tiles, 3 tensor_core) and, with splits > 1, the
// second pass over the split partials in ws (splits x m x n float32).
// a (m, k) and b (k, n) row-major, both float32 (in_bf16 = 0) or both
// bfloat16 (in_bf16 = 1); bias (n,) float32 or null; out (m, n) float32
// (out_bf16 = 0) or bfloat16. act: 0 linear, 1 tanh, 2 sigmoid, 3 relu
// (softplus), 4 strict_relu. tile: the stream form's row bucket, or the
// tile rows of the tiles (64, 128) and tensor_core (128) forms. Split s
// covers K rows [s * kchunk, min(k, (s + 1) * kchunk)). Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// plan the kernels do not take (nothing is launched then).
extern "C" int veles_gemm_bias_act(const void* a, const void* b,
                                   const void* bias, void* out, void* ws,
                                   int m, int n, int k, int in_bf16,
                                   int out_bf16, int act, int form, int tile,
                                   int splits, int kchunk, void* stream) {
  Call c{a, b, static_cast<const float*>(bias), out,
         splits > 1 ? static_cast<float*>(ws) : nullptr,
         m, n, k, act, tile, splits, kchunk,
         static_cast<cudaStream_t>(stream)};
  if (form != kGeneral &&
      (splits < 1 || kchunk < 1 || (splits > 1 && ws == nullptr) ||
       (long long)(splits - 1) * kchunk >= k ||
       (long long)splits * kchunk < k || n % 4 != 0))
    return cudaErrorInvalidValue;
  if (form == kGeneral && splits != 1) return cudaErrorInvalidValue;
  const int status = out_bf16 ? launch_form<__nv_bfloat16>(c, form, in_bf16)
                              : launch_form<float>(c, form, in_bf16);
  if (status != 0) return status;
  if (c.ws != nullptr) {
    if (out_bf16)
      launch_reduce<__nv_bfloat16>(c);
    else
      launch_reduce<float>(c);
  }
  return static_cast<int>(cudaGetLastError());
}
