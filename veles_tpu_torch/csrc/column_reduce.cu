// Column sum of a row-major (R, C) matrix, float32 or bfloat16 in, float32
// out: out[c] = sum_r x[r, c].
//
// Replaces the TPU kernel of `pallas_column_reduce`
// (veles_tpu/ops/reduce.py), which walks row blocks in grid order and
// carries a float32 accumulator in VMEM from one grid step to the next. In
// the port it computes every bias gradient of AlexNet's training step: the
// conv biases over (B*H*W, C) rows of the NHWC gradient (conv1 at batch 128:
// 401408 x 96) and the fc and head biases over (B, N) (128 x 4096,
// 128 x 1000).
//
// Bound on an H100 SXM (3.35 TB/s): memory. It reads every value once and
// does one add per value; conv1's float32 gradient is 154 MB, 46 us at
// least. The fc-sized calls (2 MB) are bound by their launches.
//
// Design: blocks run in parallel and in no order on Hopper, so nothing can
// carry over between them. Two passes, no float atomics, so two runs give
// the same bits:
// * pass 1: block (x, y) sums column tile x (32 columns, one per lane, so a
//   warp's loads of one row are contiguous) over row chunk y; its 8 warps
//   take every 8th row of the chunk, then warp 0 adds the 8 warp sums in
//   order and writes one float32 partial per column;
// * pass 2: one thread per column adds the chunks' partials in order.
// The chunk count depends only on (R, C) (about 8 blocks per SM), and the
// wrapper allocates the (chunks, C) float32 scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;
constexpr int kWarps = 8;
constexpr int kTargetBlocks = 132 * 8;
constexpr int kMinChunkRows = 4 * kWarps;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

long long chunk_rows(long long rows, int cols) {
  const long long tiles = (cols + kCols - 1) / kCols;
  long long chunks = (kTargetBlocks + tiles - 1) / tiles;
  long long per = (rows + chunks - 1) / chunks;
  if (per < kMinChunkRows) per = kMinChunkRows;
  return (per + kWarps - 1) / kWarps * kWarps;
}

template <typename T>
__global__ void __launch_bounds__(kCols * kWarps)
column_partials(const T* __restrict__ x, float* __restrict__ partial,
                long long rows, int cols, long long rows_per_chunk) {
  __shared__ float sums[kWarps][kCols];
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + lane;
  const long long start = (long long)blockIdx.y * rows_per_chunk;
  const long long stop = min(rows, start + rows_per_chunk);
  float acc = 0.0f;
  if (col < cols) {
#pragma unroll 4
    for (long long r = start + warp; r < stop; r += kWarps)
      acc += to_f32(x[r * cols + col]);
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w][lane];
    partial[(long long)blockIdx.y * cols + col] = total;
  }
}

__global__ void column_totals(const float* __restrict__ partial,
                              float* __restrict__ out, int chunks, int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float total = 0.0f;
  for (int c = 0; c < chunks; ++c) total += partial[(long long)c * cols + col];
  out[col] = total;
}

}  // namespace

// Row chunks of pass 1 for (rows, cols): the wrapper's scratch holds
// chunks * cols floats.
extern "C" int veles_column_reduce_chunks(long long rows, int cols) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long per = chunk_rows(rows, cols);
  return (int)((rows + per - 1) / per);
}

// x: (rows, cols) row-major, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// partial: veles_column_reduce_chunks(rows, cols) * cols float32 scratch;
// out: cols float32. rows, cols > 0. Returns cudaGetLastError() after the
// two launches.
extern "C" int veles_column_reduce(const void* x, void* partial, void* out,
                                   long long rows, int cols, int bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per = chunk_rows(rows, cols);
  const int chunks = (int)((rows + per - 1) / per);
  const dim3 grid((cols + kCols - 1) / kCols, chunks);
  float* part = static_cast<float*>(partial);
  if (bf16) {
    column_partials<__nv_bfloat16><<<grid, kCols * kWarps, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, rows, cols, per);
  } else {
    column_partials<float><<<grid, kCols * kWarps, 0, s>>>(
        static_cast<const float*>(x), part, rows, cols, per);
  }
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  column_totals<<<(cols + 255) / 256, 256, 0, s>>>(
      part, static_cast<float*>(out), chunks, cols);
  return static_cast<int>(cudaGetLastError());
}
