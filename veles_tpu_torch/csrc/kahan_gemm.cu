// a @ b with the K products summed in bk-deep blocks that join the sum
// through Kahan compensation: the precision_level=1 GEMM.
//
// Replaces the TPU kernel `_kahan_gemm_kernel` reached through
// `pallas_kahan_gemm` (veles_tpu/ops/gemm.py), which keeps the accumulator
// and its compensation in VMEM while the grid walks K in 512-deep blocks.
// It serves `kahan_matmul` / `gemm(precision_level=1)` and the
// GEMM-disciplines bench. What every form computes, as `_kahan_matmul_loop`:
// K in bk-deep blocks (the last one K mod bk deep), each block's float32
// partial product `term` joining the sum by
//   y = term - comp; t = acc + y; comp = (t - acc) - y; acc = t
// written with __fsub_rn/__fadd_rn so nvcc can neither contract nor
// reassociate it (the build has no -use_fast_math); the output is acc, in
// float32.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on the CUDA cores,
// 495 TFLOP/s dense TF32 and 989 bf16 on the tensor cores): a
// float32-accurate product by 3xTF32 takes 3 * 2MNK tensor-core operations,
// 0.059 ms at fc6 forward (128 x 9216 @ 9216 x 4096) against 0.145 ms for
// 2MNK on the CUDA cores and 0.047 ms to move the operands and the output
// once, so operations on the tensor cores bound the float32 shapes. With
// bf16 operands one bf16 product is exact in float32, and the bytes bound:
// 0.024 ms at fc6.
//
// Two forms, picked by `kahan_plan` (ops/gemm.py):
//
// * mma: the tensor cores by wgmma. A block of 256 threads (two
//   warpgroups, 64 rows each) owns 128 x 128 outputs; K comes in stages by
//   16-byte cp.async copies, zero-filled at the ragged M, N and K edges.
//   - float32 operands, 3xTF32: each value x splits into hi = rna(x) and
//     lo = rna(x - hi), rna the rounding of cvt.rna.tf32.f32 done by
//     integer operations (tf32_rna); wgmma m64n128k8 accumulates
//     lo_a*hi_b, hi_a*lo_b and hi_a*hi_b in float32 (lo*lo, ~2^-22 of a
//     product, is dropped). wgmma takes TF32 operands K-major only, and b
//     (K, N) is row-major, so a stage of 32 K values lands raw in shared
//     memory and the block splits it into four K-major planes (a_hi, a_lo,
//     b_hi, b_lo; b transposed on the way), 128-byte swizzled, between two
//     barriers; the next stage's copies run under the wgmmas.
//   - bf16 operands: one bf16 product (exact in float32), wgmma m64n64k16
//     with a K-major and b MN-major through the descriptor's transpose bit,
//     from a 3-stage ring of 64 K values written by cp.async straight into
//     the 128-byte swizzle.
//   The tensor cores' own summation inside a wgmma does not round as IEEE
//   adds do, so every 16 (float32) or 64 (bf16) K values of a stage
//   accumulate into a fresh register fragment `part` (scale-d 0) that then
//   joins `term` by __fadd_rn. The Kahan pair acc and comp is touched once
//   a bk block, so it lives in shared memory (each thread its own 64
//   pairs, [value][thread], no bank conflicts), which leaves part and term
//   the registers.
//   K is split over whole Kahan blocks when the tiles alone leave SMs idle:
//   split s Kahan-sums its blocks from zero and writes its (acc, comp) pair
//   to the workspace; a second kernel in the same call joins the splits in
//   split order, comp += comp_s, then acc_s joins acc by the compensated
//   add. No float atomics: two calls give the same bits.
//   Takes a and b 16-byte aligned, N and K multiples of 4 (float32) or 8
//   (bf16), and block ends on a whole wgmma step (bk a multiple of 8 or 16,
//   or one block).
// * general: the first, SIMT kernel for everything else (bk below the wgmma
//   depth, rows or pointers not 16-byte aligned, K = 0): 64 x 64 outputs a
//   block, 4 x 4 a thread, 16-deep FMA sub-sums, any M, N, K and bk >= 1,
//   masked on load and store, one split.
//
// Not done yet: a warp-specialised producer (TMA), and keeping the tensor
// cores busy while part joins term (a second part fragment does not fit
// beside term in the registers). Splitting the next float32 stage under
// the current stage's wgmmas, with 16-deep stages and two plane buffers
// (acc/comp leave no room for two 32-deep ones), was no faster on an H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// -- general form -----------------------------------------------------------

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
kahan_gemm_general(const T* __restrict__ a, const T* __restrict__ b,
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

// -- mma form: the tensor cores by wgmma --------------------------------------

constexpr int kMmaThreads = 256;  // two warpgroups, 64 rows of the tile each
constexpr int kMmaBM = 128, kMmaBN = 128;  // outputs a block
constexpr int kOuts = 64;                  // outputs a thread, 2 x 32
constexpr int kAccBytes = 2 * kOuts * kMmaThreads * 4;  // acc and comp
// float32: 32 K values a stage (128 B a row); the four hi/lo planes (128
// rows of a's tile or of b's columns, K-major) and the raw stage, a
// [128][32] and b [32][128]
constexpr int kF32Depth = 32;
constexpr int kF32Plane = kMmaBM * kF32Depth * 4;
constexpr int kF32Smem = 6 * kF32Plane + kAccBytes + 1024;
// bf16: 64 K values a stage (128 B a row); a ring of stages, each a
// (K-major) and b's two 64-column boxes (MN-major, 64 rows of 128 B)
constexpr int kBf16Depth = 64, kBf16Stages = 3;
constexpr int kBf16A = kMmaBM * kBf16Depth * 2, kBf16Box = kBf16Depth * 128;
constexpr int kBf16Stage = kBf16A + 2 * kBf16Box;
constexpr int kBf16Smem = kBf16Stages * kBf16Stage + kAccBytes + 1024;
static_assert(kF32Smem <= 232448 && kBf16Smem <= 232448, "one block an SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 fills the 16 bytes with zeros (ragged M, N and K edges)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows with
// the 128-byte swizzle (tiles start on its 1024-byte grid)
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
// wgmma shared-memory descriptor, 128-byte swizzle: 8-row groups 1024 B
// apart; for b's MN-major 64-column boxes a 64-wide instruction stays
// inside one swizzle atom along N, so the leading offset is 1024 B too
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  const uint64_t enc = (1024u >> 4) & 0x3FFF;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (enc << 16) | (enc << 32) |
         (1ull << 62);
}
// shared-memory writes by threads (cp.async, stores) made visible to the
// wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Accumulators of a warpgroup's 64 x 128 outputs: register 4j + 2h + c of
// d[box] holds row 16 * warp + lane / 4 + 8h, column 64 box + 8j +
// 2 (lane % 4) + c. (d0, d1) = a (64 x 8, K-major) @ b (8 x 128, K-major)
// + (accumulate ? (d0, d1) : 0), TF32 operands.
__device__ __forceinline__ void wgmma_tf32(float (&d0)[32], float (&d1)[32],
                                           uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}
// d = a (64 x 16, K-major) @ b (16 x 64, MN-major: the transpose bit) +
// (accumulate ? d : 0), bf16 operands
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// x rounded to TF32 (10 mantissa bits), ties away from zero, as
// cvt.rna.tf32.f32 rounds: half of TF32's last place added to the magnitude
// bits, the 13 low bits cleared: two integer operations, cheaper than the
// cvt instruction in this kernel on an H100 (timed side by side). A NaN whose
// payload fills the top mantissa bits (CUDA's own, 0x7fffffff) would wrap
// to -0, so lo keeps x - hi when that is NaN: a NaN in x stays a NaN.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  const float d = __fsub_rn(x, __uint_as_float(hi));
  lo = d == d ? tf32_rna(d) : __float_as_uint(d);
}
__device__ __forceinline__ void split_store(float x0, float x1, float x2,
                                            float x3, unsigned char* hi,
                                            unsigned char* lo) {
  uint4 h, l;
  split_tf32(x0, h.x, l.x);
  split_tf32(x1, h.y, l.y);
  split_tf32(x2, h.z, l.z);
  split_tf32(x3, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// Split blockIdx.z's K rows [kb0, kb1) in stages of `depth`: every Kahan
// block of the split but the last (ragged at K's end) takes spb stages.
struct Stages {
  int kb0, kb1, bk, spb, count, depth;
  __device__ Stages(int k, int bk_, int bps, int depth_)
      : bk(bk_), depth(depth_) {
    const long long span = (long long)bps * bk;
    kb0 = (int)(blockIdx.z * span);
    kb1 = (int)(k - kb0 > span ? kb0 + span : k);
    spb = (bk + depth - 1) / depth;
    const int blocks = (kb1 - kb0 + bk - 1) / bk;
    const int tail = kb1 - (kb0 + (blocks - 1) * bk);
    count = (blocks - 1) * spb + (tail + depth - 1) / depth;
  }
  // stage j's K values [k0, kend): within its block and the split
  __device__ void range(int j, int& k0, int& kend) const {
    const int blk = j / spb;
    const int c0 = kb0 + blk * bk;
    k0 = c0 + (j - blk * spb) * depth;
    kend = c0 + bk < kb1 ? c0 + bk : kb1;
    if (k0 + depth < kend) kend = k0 + depth;
  }
  __device__ bool block_end(int j) const {
    return (j + 1) % spb == 0 || j + 1 == count;
  }
};

// float32: stage j's raw tiles a [128][32] and b [32][128] (row-major) by
// cp.async, zero at and past kend and outside m, n (kend and n are
// multiples of the 4-value chunk)
__device__ __forceinline__ void load_f32(uint32_t ra, uint32_t rb,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int m,
                                         int n, int k, int row0, int col0,
                                         int k0, int kend) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 3, c = (i & 7) * 4;
    const int gr = row0 + r, gk = k0 + c;
    const bool in = gr < m && gk < kend;
    cp_async16(ra + (r * kF32Depth + c) * 4,
               in ? a + (size_t)gr * k + gk : a, in);
  }
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 5, c = (i & 31) * 4;
    const int gk = k0 + r, gc = col0 + c;
    const bool in = gk < kend && gc < n;
    cp_async16(rb + (r * kMmaBN + c) * 4, in ? b + (size_t)gk * n + gc : b,
               in);
  }
}

// float32: the raw tiles split into the planes a_hi, a_lo (rows of a) and
// b_hi, b_lo (columns of b), K-major with the 128-byte swizzle: a chunk by
// chunk, 8 lanes a row; b transposed, a lane a column, the 4 K values of one
// chunk. The swizzle puts the 8 lanes of a 16-byte store phase on 8 bank
// quads.
__device__ __forceinline__ void split_planes(const float* ra, const float* rb,
                                             unsigned char* planes) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 3, c = i & 7;
    const float4 v =
        *reinterpret_cast<const float4*>(ra + r * kF32Depth + 4 * c);
    const int o = sw128(r, c);
    split_store(v.x, v.y, v.z, v.w, planes + o, planes + kF32Plane + o);
  }
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int col = i & (kMmaBN - 1), c = i / kMmaBN;
    const float* p = rb + 4 * c * kMmaBN + col;
    const int o = 2 * kF32Plane + sw128(col, c);
    split_store(p[0], p[kMmaBN], p[2 * kMmaBN], p[3 * kMmaBN], planes + o,
                planes + kF32Plane + o);
  }
}

// bf16: stage j of the ring, a K-major and b's boxes MN-major, both in the
// 128-byte swizzle, straight from device memory by cp.async (kend and n are
// multiples of the 8-value chunk)
__device__ __forceinline__ void load_bf16(uint32_t st,
                                          const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ b,
                                          int m, int n, int k, int row0,
                                          int col0, int k0, int kend) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 3, c = i & 7;
    const int gr = row0 + r, gk = k0 + 8 * c;
    const bool in = gr < m && gk < kend;
    cp_async16(st + sw128(r, c), in ? a + (size_t)gr * k + gk : a, in);
  }
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 4, cc = i & 15;
    const int gk = k0 + r, gc = col0 + 8 * cc;
    const bool in = gk < kend && gc < n;
    cp_async16(st + kBf16A + (cc >> 3) * kBf16Box + sw128(r, cc & 7),
               in ? b + (size_t)gk * n + gc : b, in);
  }
}

// One block of 128 x 128 outputs, split blockIdx.z. Each 16- (float32) or
// 64-deep (bf16) slice of a stage accumulates into a fresh `part` that
// joins `term` by __fadd_rn; at each Kahan block's end term joins (acc,
// comp) in shared memory. ws null: acc goes to out; else (acc, comp) to
// planes 2z and 2z + 1 of ws.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
kahan_gemm_mma(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ out, float* __restrict__ ws, int m, int n,
               int k, int bk, int bps) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kRing = kF32 ? 6 * kF32Plane : kBf16Stages * kBf16Stage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 B: tiles start on that grid
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_base);
  float* acc_s = reinterpret_cast<float*>(smem + kRing);
  float* comp_s = acc_s + kOuts * kMmaThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int row0 = blockIdx.y * kMmaBM, col0 = blockIdx.x * kMmaBN;
  const Stages st(k, bk, bps, kF32 ? kF32Depth : kBf16Depth);
  auto load = [&](int j) {
    int k0, kend;
    st.range(j, k0, kend);
    if constexpr (kF32)
      load_f32(base + 4 * kF32Plane, base + 5 * kF32Plane, a, b, m, n, k,
               row0, col0, k0, kend);
    else
      load_bf16(base + (j % kBf16Stages) * kBf16Stage, a, b, m, n, k, row0,
                col0, k0, kend);
  };

  constexpr int kAhead = kF32 ? 1 : kBf16Stages - 1;  // stages in flight
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < st.count) load(s);
    cp_async_commit();
  }
  float term[2][32], part[2][32];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    acc_s[i * kMmaThreads + tid] = comp_s[i * kMmaThreads + tid] = 0.0f;
    term[i / 32][i % 32] = part[i / 32][i % 32] = 0.0f;
  }

  for (int j = 0; j < st.count; ++j) {
    uint32_t sa, sb;  // this warpgroup's rows of a, and b
    if constexpr (kF32) {
      cp_async_wait<0>();
      __syncthreads();  // stage j has landed; stage j - 1's wgmmas are done
      split_planes(reinterpret_cast<const float*>(smem + 4 * kF32Plane),
                   reinterpret_cast<const float*>(smem + 5 * kF32Plane),
                   smem);
      fence_proxy_async();
      __syncthreads();  // the planes are whole; the raw tiles are free
      if (j + 1 < st.count) load(j + 1);
      cp_async_commit();
      sa = base + wg * 64 * 128;
      sb = base + 2 * kF32Plane;
    } else {
      cp_async_wait<kBf16Stages - 2>();
      fence_proxy_async();
      __syncthreads();  // stage j has landed; slot (j - 1) % 3 is free
      if (j + kBf16Stages - 1 < st.count) load(j + kBf16Stages - 1);
      cp_async_commit();
      sa = base + (j % kBf16Stages) * kBf16Stage + wg * 64 * 128;
      sb = base + (j % kBf16Stages) * kBf16Stage + kBf16A;
    }
    // float32: two slices of 2 steps (16 K values); bf16: one of 4 (64)
    constexpr int kSlices = kF32 ? 2 : 1, kSteps = 4 / kSlices;
#pragma unroll
    for (int slice = 0; slice < kSlices; ++slice) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        // 8 (float32) or 16 (bf16) K values: 32 B along the swizzled rows
        const int kb = (kSteps * slice + s) * 32;
        if constexpr (kF32) {
          // the small products first, the large one last
          wgmma_tf32(part[0], part[1], sw128_desc(sa + kF32Plane + kb),
                     sw128_desc(sb + kb), s);
          wgmma_tf32(part[0], part[1], sw128_desc(sa + kb),
                     sw128_desc(sb + kF32Plane + kb), 1);
          wgmma_tf32(part[0], part[1], sw128_desc(sa + kb),
                     sw128_desc(sb + kb), 1);
        } else {
          // b: 16 K rows of 128 B a step
#pragma unroll
          for (int box = 0; box < 2; ++box)
            wgmma_bf16(part[box], sw128_desc(sa + kb),
                       sw128_desc(sb + box * kBf16Box + kb * 16 * 4), s);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int box = 0; box < 2; ++box)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          term[box][i] = __fadd_rn(term[box][i], part[box][i]);
    }
    if (st.block_end(j)) {
      // the block's end: the compensated add of `_kahan_matmul_loop`
#pragma unroll
      for (int i = 0; i < kOuts; ++i) {
        const int o = i * kMmaThreads + tid;
        const float acc = acc_s[o], comp = comp_s[o];
        const float y = __fsub_rn(term[i / 32][i % 32], comp);
        const float t = __fadd_rn(acc, y);
        comp_s[o] = __fsub_rn(__fsub_rn(t, acc), y);
        acc_s[o] = t;
        term[i / 32][i % 32] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, q = lane & 3;
  const size_t mn = (size_t)m * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int jn = 0; jn < kMmaBN / 8; ++jn) {
      // n is even, so columns c and c + 1 are both inside or both out
      const int c = col0 + 8 * jn + 2 * q;
      if (c >= n) continue;
      const int o = (4 * jn + 2 * h) * kMmaThreads + tid;
      const float2 acc = make_float2(acc_s[o], acc_s[o + kMmaThreads]);
      const size_t at = (size_t)r * n + c;
      if (ws == nullptr) {
        *reinterpret_cast<float2*>(out + at) = acc;
      } else {
        float* plane = ws + 2 * blockIdx.z * mn;
        *reinterpret_cast<float2*>(plane + at) = acc;
        *reinterpret_cast<float2*>(plane + mn + at) =
            make_float2(comp_s[o], comp_s[o + kMmaThreads]);
      }
    }
  }
}

// out = the splits' (acc, comp) pairs joined in split order: the incoming
// compensation joins the running one, then its acc joins by the compensated
// add. mn is a multiple of 4.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
kahan_merge(const float* __restrict__ ws, float* __restrict__ out,
            long long mn, int splits) {
  const long long quads = mn / 4;
  for (long long q = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
       q < quads; q += (long long)gridDim.x * kMergeThreads) {
    const float4* w = reinterpret_cast<const float4*>(ws);
    const float4 a0 = w[q], c0 = w[quads + q];
    float acc[4] = {a0.x, a0.y, a0.z, a0.w};
    float comp[4] = {c0.x, c0.y, c0.z, c0.w};
    for (int s = 1; s < splits; ++s) {
      const float4 sa = w[2 * s * quads + q], sc = w[(2 * s + 1) * quads + q];
      const float as[4] = {sa.x, sa.y, sa.z, sa.w};
      const float cs[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        comp[e] = __fadd_rn(comp[e], cs[e]);
        const float y = __fsub_rn(as[e], comp[e]);
        const float t = __fadd_rn(acc[e], y);
        comp[e] = __fsub_rn(__fsub_rn(t, acc[e]), y);
        acc[e] = t;
      }
    }
    reinterpret_cast<float4*>(out)[q] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <typename T>
int launch_mma(const void* a, const void* b, float* out, float* ws, int m,
               int n, int k, int bk, int splits, int bps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);            // values a 16-byte chunk
  constexpr int kStep = sizeof(T) == 4 ? 8 : 16;  // K values one wgmma takes
  constexpr int kSmem = sizeof(T) == 4 ? kF32Smem : kBf16Smem;
  const long long span = (long long)bps * bk;
  if (k < 1 || n % kVec != 0 || k % kVec != 0 ||
      (bk % kStep != 0 && bk < k) || splits < 1 || bps < 1 ||
      (splits - 1) * span >= k || splits * span < k ||
      (splits > 1 && ws == nullptr) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(kahan_gemm_mma<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    done = true;
  }
  const dim3 grid((n + kMmaBN - 1) / kMmaBN, (m + kMmaBM - 1) / kMmaBM,
                  splits);
  kahan_gemm_mma<T><<<grid, kMmaThreads, kSmem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out,
      splits > 1 ? ws : nullptr, m, n, k, bk, bps);
  if (splits > 1) {
    const long long quads = (long long)m * n / 4;
    long long blocks = (quads + kMergeThreads - 1) / kMergeThreads;
    if (blocks > 2048) blocks = 2048;
    kahan_merge<<<(int)blocks, kMergeThreads, 0, s>>>(ws, out,
                                                      (long long)m * n,
                                                      splits);
  }
  return 0;
}

template <typename T>
void launch_general(const void* a, const void* b, float* out, int m, int n,
                    int k, int bk, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  kahan_gemm_general<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, m, n, k, bk);
}

enum Form { kGeneral = 0, kMmaForm = 1 };

}  // namespace

// out (m, n) float32 row-major = a (m, k) @ b (k, n), both row-major and
// contiguous, K summed in bk-deep blocks joined by Kahan compensation. a and
// b both float32 (in_bf16 = 0) or both bfloat16 (in_bf16 = 1). form 0
// (general): one split, m <= 65535 * 64, k >= 0. form 1 (mma): split s of
// `splits` covers bps Kahan blocks, K rows [s * bps * bk, min(k, (s + 1) *
// bps * bk)); with splits > 1, ws holds 2 * splits * m * n float32. m, n >=
// 1, bk >= 1. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan the kernels do not take (nothing is
// launched then).
extern "C" int veles_kahan_gemm(const void* a, const void* b, void* out,
                                void* ws, int m, int n, int k, int bk,
                                int in_bf16, int form, int splits, int bps,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  if (m < 1 || n < 1 || k < 0 || bk < 1) return cudaErrorInvalidValue;
  if (form == kGeneral) {
    if (splits != 1) return cudaErrorInvalidValue;
    if (in_bf16)
      launch_general<__nv_bfloat16>(a, b, o, m, n, k, bk, s);
    else
      launch_general<float>(a, b, o, m, n, k, bk, s);
  } else if (form == kMmaForm) {
    const int status =
        in_bf16 ? launch_mma<__nv_bfloat16>(a, b, o, w, m, n, k, bk, splits,
                                            bps, s)
                : launch_mma<float>(a, b, o, w, m, n, k, bk, splits, bps, s);
    if (status != 0) return status;
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
