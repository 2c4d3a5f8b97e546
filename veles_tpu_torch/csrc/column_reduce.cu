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
// least. The fc-sized calls (2 MB) are bound by their launch.
//
// Design. Blocks run in parallel and in no order on Hopper, so nothing
// carries over between them; no float atomics, so two calls give the same
// bits. The plan (`column_plan` in ops/reduce.py) picks:
// * vec: columns a thread loads at once, 16 bytes (4 float32, 8 bf16)
//   where C and the pointer allow it, else 1 (scalar loads);
// * tile: vectors of a column tile (blockIdx.x). The block's 256 threads
//   are 256 / tile row slots of `tile` lanes; slot s takes rows s, s + P,
//   ... of its row range, 8 loads in flight, into 4 accumulators;
// * chunks: row ranges (blockIdx.y). The single form (chunks = 1) sums
//   all R rows in one block per tile and writes out. The chunked form
//   writes one float32 partial row per chunk; the block that takes the
//   last integer ticket of its tile (after a __threadfence) sets the
//   ticket back to 0, then sums the tile's partials in the same slot
//   order and writes out. The wrapper keeps one ticket buffer per card
//   and stream, zeroed once: calls on one stream run in order, and calls
//   on two streams never share tickets.
// Every sum is taken in an order fixed by (R, C) alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;  // rows in flight per thread
constexpr int kAccs = 4;   // accumulators per column

// Loads of VEC columns as floats: a 16-byte vector, or one value.
template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 1> {
  __device__ __forceinline__ static void at(const float* p, float* v) {
    v[0] = __ldcs(p);
  }
};
template <>
struct Load<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void at(const __nv_bfloat16* p,
                                            float* v) {
    v[0] = __bfloat162float(*p);
  }
};
template <>
struct Load<float, 4> {
  __device__ __forceinline__ static void at(const float* p, float* v) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};
template <>
struct Load<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void at(const __nv_bfloat16* p,
                                            float* v) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float is exact: the top half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// The partials, float32 in L2 (written by other blocks: read past L1).
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(p + i));
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldcg(p + i);
  }
}

// Slot sums of rows [r0, r1) of `src` (row stride `cols`) at vector column
// `col`: this thread takes rows r0 + slot, r0 + slot + slots, ... in
// batches of kLoads loads in flight (rows past r1 read as 0), row j of a
// batch into accumulator j % kAccs, the accumulators joined in a fixed
// order.
template <typename T, int VEC, bool PARTIAL>
__device__ __forceinline__ void slot_sum(const T* __restrict__ src,
                                         long long r0, long long r1,
                                         int cols, long long col, int slot,
                                         int slots, float* total) {
  float acc[kAccs][VEC];
#pragma unroll
  for (int a = 0; a < kAccs; ++a)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[a][i] = 0.0f;
  const long long step = slots;
  for (long long r = r0 + slot; r < r1; r += kLoads * step) {
    float v[kLoads][VEC];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long row = r + j * step;
      if (row < r1) {
        const T* p = src + row * cols + col;
        if constexpr (PARTIAL)
          load_partial<VEC>(p, v[j]);
        else
          Load<T, VEC>::at(p, v[j]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[j % kAccs][i] += v[j][i];
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    total[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
}

// Join the slots' sums in slot order (slot 0's threads hold the result).
template <int VEC>
__device__ __forceinline__ void join_slots(float* sums, const float* mine,
                                           int slot, int lane, int tile,
                                           int slots, float* total) {
  if (slot < slots) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      sums[(slot * tile + lane) * VEC + i] = mine[i];
  }
  __syncthreads();
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) total[i] = sums[lane * VEC + i];
    for (int s = 1; s < slots; ++s) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        total[i] += sums[(s * tile + lane) * VEC + i];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const T* __restrict__ x, float* __restrict__ partial,
                  unsigned* __restrict__ tickets, float* __restrict__ out,
                  long long rows, int cols, int tile, long long chunk_rows) {
  __shared__ float sums[kThreads * VEC];
  __shared__ bool last;
  const int slots = kThreads / tile;
  const int slot = threadIdx.x / tile;
  const int lane = threadIdx.x % tile;
  const long long vcol = (long long)blockIdx.x * tile + lane;
  const bool valid = slot < slots && vcol * VEC < cols;
  const long long col = vcol * VEC;
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);

  float mine[VEC], total[VEC];
  if (valid) {
    slot_sum<T, VEC, false>(x, r0, r1, cols, col, slot, slots, mine);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[i] = 0.0f;
  }
  join_slots<VEC>(sums, mine, slot, lane, tile, slots, total);
  if (gridDim.y == 1) {  // the single form
    if (slot == 0 && valid) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[col + i] = total[i];
    }
    return;
  }
  if (slot == 0 && valid) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      partial[(long long)blockIdx.y * cols + col + i] = total[i];
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
    if (last) tickets[blockIdx.x] = 0;  // every other block has taken one
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (valid) {
    slot_sum<float, VEC, true>(partial, 0, gridDim.y, cols, col, slot,
                               slots, mine);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[i] = 0.0f;
  }
  join_slots<VEC>(sums, mine, slot, lane, tile, slots, total);
  if (slot == 0 && valid) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[col + i] = total[i];
  }
}

template <typename T, int VEC>
void launch(const void* x, void* tickets, void* partial, void* out,
            long long rows, int cols, int tile, int chunks,
            long long chunk_rows, cudaStream_t s) {
  const int tiles = (int)((cols / VEC + tile - 1) / tile);
  column_sum_kernel<T, VEC><<<dim3(tiles, chunks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(partial),
      static_cast<unsigned*>(tickets), static_cast<float*>(out), rows, cols,
      tile, chunk_rows);
}

}  // namespace

// x: (rows, cols) row-major, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// out: cols float32. The rest is `column_plan`'s: vec (1, or 16 bytes of
// values with cols % vec == 0 and x 16-byte aligned), tile (vectors per
// column tile), chunks and chunk_rows (chunks = 1: the single form, which
// reads neither tickets nor partial). The chunked form takes one uint32
// ticket per column tile, 0 on entry and left 0, and chunks * cols
// float32 partials. rows, cols > 0. Returns cudaGetLastError().
extern "C" int veles_column_reduce(const void* x, void* tickets,
                                   void* partial, void* out, long long rows,
                                   int cols, int bf16, int vec, int tile,
                                   int chunks, long long chunk_rows,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec == 8)
      launch<__nv_bfloat16, 8>(x, tickets, partial, out, rows, cols, tile,
                               chunks, chunk_rows, s);
    else
      launch<__nv_bfloat16, 1>(x, tickets, partial, out, rows, cols, tile,
                               chunks, chunk_rows, s);
  } else {
    if (vec == 4)
      launch<float, 4>(x, tickets, partial, out, rows, cols, tile, chunks,
                       chunk_rows, s);
    else
      launch<float, 1>(x, tickets, partial, out, rows, cols, tile, chunks,
                       chunk_rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}
