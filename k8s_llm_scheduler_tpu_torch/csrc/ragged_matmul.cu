// K3: ragged-M matmul of block decode, out = x[M, K] @ w[K, N] over only the
// first ceil(total / 64) * 64 rows; later rows are written as zeros. Written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/ragged_matmul.py _kernel
// (pl.pallas_call in ragged_matmul). Block decode compacts each iteration's
// valid tokens to the front of its [R*F, D] activation; every projection and
// MLP matmul of the layer (wq, wk, wv, wo, w_gate, w_up, w_down) runs here
// with the valid-token count `total` read from device memory, so the work
// follows the real tokens and no host sync is needed.
//
// Weights are bf16, or int8 with a per-output-channel f32 scale. The product
// accumulates in f32 and the scale multiplies the f32 sum once, before the
// single rounding to bf16 (the TPU kernel's order: x @ bf16(q), times scale,
// cast). No bf16 copy of an int8 weight exists anywhere.
//
// What bounds it. At decode the active rows are few (1-8 valid tokens, so one
// 64-row tile; at most M = R*F = 192 at R = 8), so a call must read every
// weight byte once: 1 byte a weight for int8, 2 for bf16, against 2 * rows
// operations. Even at 192 rows that is under the card's ~295 flop/byte
// ridge, so HBM bandwidth bounds every shape of the path, and the design is
// about streaming the weight through every SM that can take part:
// - Swap A and B: the kernel computes out^T = w^T x^T, so 64 weight columns
//   are wgmma's M side and the active rows its N (64, 128 or 192, chosen on
//   the device from `total` by a uniform branch). A block owns kBN weight
//   columns (one 64-column slice per consumer warpgroup) and a range of K.
// - One producer warp keeps TMA loads of a ring of stages in flight (one
//   weight tile [kBK x kBN] and the active rows' x tile [rows x kBK] each),
//   with full/empty mbarriers; the consumers spend no instruction on loads,
//   and `setmaxnreg` moves the producer's registers to them. The ring fills
//   the shared memory: at 64 rows, 14 int8 stages (112 KB of weight) or 9
//   bf16 stages (144 KB) are in flight per SM. Weight loads carry an L2
//   evict-first policy (each weight byte is read once a call; x and the
//   split workspace are read again), and the tensor maps are prefetched
//   while the barriers are set up.
// - An int8 weight tile is read by `ldmatrix.trans` as b16 pairs of
//   neighbouring columns, so each lane gets two k values of two columns; a
//   byte split and exact convert (f32 magic number, then cvt to bf16x2) make
//   wgmma's register A fragment from it, whose rows are the weight columns in
//   the order 0, 2, 4, .. 14, 1, 3, .. 15 of each 16 (`fragment_columns` in
//   ops/ragged_matmul.py); the epilogue undoes that when it reads `scale`
//   and writes `out`. A bf16 weight tile is wgmma's A straight from shared
//   memory (MN-major, the transpose bit). x is B, K-major, 128-byte swizzle.
// - Where N has fewer column tiles than the card has SMs, K is split over
//   blocks (ops/ragged_matmul.py k_splits, at most kMaxSplits), so that
//   128 of 132 SMs stream at every 8B shape but w_gate / w_up (112 column
//   tiles, no split). The splits' f32 partials go to a workspace at the
//   active rows only (it stays in the L2), and a second kernel sums them in
//   split order (deterministic), scales, rounds and writes the zero rows.
// Measured on an H100 (PERF.md, PR 5): a block streams ~20 GB/s of weight
// whatever the ring's depth, the rows or the column width, and the math
// costs ~13% over the ring alone, so the time follows the number of SMs
// streaming; a split through a cluster's shared memory lost to this
// workspace, because a card whose GPCs hold 30 clusters of 4 runs 32 of
// them in two waves.
// Rows past 192 (a wider batch) run as further passes over the weights.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/ragged_matmul.py). The tensor maps
// of x and w are encoded on the host for every call (hopper.cuh), so the
// call stays capturable in a CUDA graph.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch_utils.cuh"

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
constexpr int kBN = 64 * kConsumers;              // weight columns per block
constexpr int kBK = 64;                           // K per ring stage
constexpr int kRowTile = 64;   // rows per x box: work is whole tiles up to total
constexpr int kMaxRows = 192;  // rows per pass over the weights (wgmma N)
constexpr int kMaxSplits = 16;  // K splits of a column tile
constexpr int kXBoxBytes = kRowTile * kBK * 2;  // one x box, 128-byte rows
constexpr int kWSliceBytes = kBK * 64 * 2;      // one bf16 weight box: 64 columns
constexpr int kRingBytes = 224 * 1024;
constexpr int kMaxStages = 16;
// the ring, 1024 bytes to align it for the 128-byte swizzle, the barriers
constexpr int kSmemBytes = kRingBytes + 1024 + 2 * kMaxStages * 8;

template <typename W>
__host__ __device__ constexpr int w_stage_bytes() {
  return kBK * kBN * int(sizeof(W));
}

// The ring's geometry for a call whose passes take at most `rows` rows: the
// weight tile then the x tile in each stage, as many stages as fit.
struct Ring {
  int stages, stage_bytes;
};

template <typename W>
__host__ __device__ Ring ring_for(int rows) {
  const int bytes = w_stage_bytes<W>() + rows * kBK * 2;
  const int stages = kRingBytes / bytes;
  return {stages < kMaxStages ? stages : kMaxStages, bytes};
}

struct Params {
  const float* scale;  // [N] f32 for int8 weights, else null
  const int* total;
  __nv_bfloat16* out;
  float* part;  // split workspace [splits, M, N] f32 (splits > 1)
  int M, N, K, k_per_split, splits;
};

// Rows that get computed: every 64-row tile up to the one holding row
// total - 1, capped at M.
__device__ __forceinline__ int active_rows(const int* total_ptr, int M) {
  int total = *total_ptr;
  total = total < 0 ? 0 : (total > M ? M : total);
  const int rows = (total + kRowTile - 1) / kRowTile * kRowTile;
  return rows < M ? rows : M;
}

__device__ __forceinline__ int pass_rows(int rows_left) {
  const int r = (rows_left + kRowTile - 1) / kRowTile * kRowTile;
  return r < kMaxRows ? r : kMaxRows;
}

// Four int8 weights (bytes b0..b3 of v) as two bf16 pairs {b0, b2} and
// {b1, b3}, exactly: 2^23 + (q + 128) as an f32 has q + 128 in its low
// mantissa byte, and subtracting 2^23 + 128 leaves q.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& even,
                                               uint32_t& odd) {
  const uint32_t u = v ^ 0x80808080u;
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - kBias;
  even = pack_bf16(f0, f2);
  odd = pack_bf16(f1, f3);
}

// x as wgmma's B operand: K-major rows of 128 bytes (kBK bf16), 8-row groups
// 1024 bytes apart, a k-step of 16 is 32 bytes along the row.
__device__ __forceinline__ uint64_t x_desc(uint32_t tile, int s) {
  return sw128_desc(tile + s * 32, 16, 1024);
}

// A bf16 weight slice [kBK k][64 columns] as wgmma's A operand, MN-major
// (the transpose bit): a k-step of 16 is 16 rows of 128 bytes, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t w_desc(uint32_t slice, int s) {
  return sw128_desc(slice + s * 16 * 128, kWSliceBytes, 1024);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (N == 64) {
    wgmma_n64<0>(d, a, b, 1);
  } else if constexpr (N == 128) {
    wgmma_n128<0>(d, a, b, 1);
  } else {
    wgmma_n192<0>(d, a, b, 1);
  }
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) {
    wgmma_ss_n64<1, 0>(d, a, b, 1);
  } else if constexpr (N == 128) {
    wgmma_ss_n128<1, 0>(d, a, b, 1);
  } else {
    wgmma_ss_n192<1, 0>(d, a, b, 1);
  }
}

// One thread issues every load: per stage the weight tile (int8: one box of
// kBK x kBN bytes; bf16: one box of kBK x 64 per consumer) and the pass's x
// rows (one box per 64 rows). Stage g of the call is ring slot g % stages.
template <typename W>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, Ring geo, int n0, int k_begin,
                                        int n_k, int rows_active) {
  // the weight is read once a call; x (and the split workspace) again
  const uint64_t policy = l2_evict_first();
  int g = 0;
  for (int row0 = 0; row0 < rows_active; row0 += kMaxRows) {
    const int boxes = pass_rows(rows_active - row0) / kRowTile;
    for (int t = 0; t < n_k; ++t, ++g) {
      const int st = g % geo.stages;
      mbar_wait(&empty[st], ((g / geo.stages) & 1) ^ 1);
      unsigned char* wdst = ring + st * geo.stage_bytes;
      unsigned char* xdst = wdst + w_stage_bytes<W>();
      mbar_expect_tx(&full[st], w_stage_bytes<W>() + boxes * kXBoxBytes);
      const int k = k_begin + t * kBK;
      if constexpr (sizeof(W) == 1) {
        tma_load_2d_hint(wdst, wmap, &full[st], n0, k, policy);
      } else {
#pragma unroll
        for (int c = 0; c < kConsumers; ++c)
          tma_load_2d_hint(wdst + c * kWSliceBytes, wmap, &full[st], n0 + 64 * c, k,
                           policy);
      }
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(xdst + b * kXBoxBytes, xmap, &full[st], k, row0 + b * kRowTile);
    }
  }
}

// One consumer warpgroup, one pass of N rows from row0: the 64 weight
// columns of its slice against the pass's rows over the block's K range,
// then the epilogue. Warp w's accumulator rows are the slice's columns
// 16w..16w+15; this thread holds two of them (h = 0, 1) for tokens
// 8j + 2tq + e.
template <typename W, int N>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, Ring geo,
                                        int g0, int n0, int n_k, int row0,
                                        int rows_active) {
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_k; ++t) {
    const int g = g0 + t;
    const int st = g % geo.stages;
    mbar_wait(&full[st], (g / geo.stages) & 1);
    unsigned char* wst = ring + st * geo.stage_bytes;
    const uint32_t xst = smem_u32(wst + w_stage_bytes<W>());
    if constexpr (sizeof(W) == 1) {
      // Lane l addresses k row 32h + l of the warp's 16 columns (one
      // 16-byte chunk, at its 128-byte-swizzled place): matrix m of load h
      // holds k rows 32h + 8m .. +7.
      uint32_t raw[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 32 * h + lane;
        ldmatrix_x4_trans(raw[h], wst + k * 128 + (((4 * wg + warp) ^ (k & 7)) << 4));
      }
      uint32_t a[kBK / 16][4];
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        int8x4_to_bf16(raw[s / 2][2 * (s % 2)], a[s][0], a[s][1]);
        int8x4_to_bf16(raw[s / 2][2 * (s % 2) + 1], a[s][2], a[s][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) mma_rs<N>(acc, a[s], x_desc(xst, s));
    } else {
      const uint32_t slice = smem_u32(wst) + wg * kWSliceBytes;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) mma_ss<N>(acc, w_desc(slice, s), x_desc(xst, s));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // The weight columns of accumulator rows gq (h = 0) and gq + 8 (h = 1):
  // int8 fragments hold neighbouring columns 2gq, 2gq + 1; bf16 ones the
  // columns in order.
  const int cbase = n0 + 64 * wg + 16 * warp;
  const int c0 = sizeof(W) == 1 ? cbase + 2 * gq : cbase + gq;
  const int c1 = sizeof(W) == 1 ? c0 + 1 : c0 + 8;
  float s0 = 1.f, s1 = 1.f;
  if (p.scale != nullptr) {
    if (c0 < p.N) s0 = p.scale[c0];
    if (c1 < p.N) s1 = p.scale[c1];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + 8 * j + 2 * tq + e;
      if (row >= rows_active) continue;
      const float v0 = acc[4 * j + e];
      const float v1 = acc[4 * j + 2 + e];
      const long long base = static_cast<long long>(row) * p.N;
      if (p.splits > 1) {
        float* part = p.part + static_cast<long long>(blockIdx.y) * p.M * p.N + base;
        if (c0 < p.N) part[c0] = v0;
        if (c1 < p.N) part[c1] = v1;
      } else if (sizeof(W) == 1) {
        // N is a multiple of 16 for int8: the pair is in or out together
        if (c0 < p.N)
          *reinterpret_cast<__nv_bfloat162*>(p.out + base + c0) =
              __floats2bfloat162_rn(v0 * s0, v1 * s1);
      } else {
        if (c0 < p.N) p.out[base + c0] = __float2bfloat16_rn(v0);
        if (c1 < p.N) p.out[base + c1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// Grid: (column tiles of kBN, K splits). Warpgroups 0..kConsumers-1
// consume, the last one produces (one thread issues the TMA loads).
template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_kernel(__grid_constant__ const CUtensorMap xmap,
                  __grid_constant__ const CUtensorMap wmap, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kMaxStages;

  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.y * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int n_k = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int rows_active = active_rows(p.total, p.M);
  const Ring geo = ring_for<W>(pass_rows(rows_active));

  if (threadIdx.x == kConsumers * 128) {  // the producer's thread, ahead of its loads
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&wmap);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128)
      produce<W>(&xmap, &wmap, ring, full, empty, geo, n0, k_begin, n_k, rows_active);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int g0 = 0;
    for (int row0 = 0; row0 < rows_active; row0 += kMaxRows, g0 += n_k) {
      const int rows = pass_rows(rows_active - row0);
      if (rows == 192) {
        consume<W, 192>(p, ring, full, empty, geo, g0, n0, n_k, row0, rows_active);
      } else if (rows == 128) {
        consume<W, 128>(p, ring, full, empty, geo, g0, n0, n_k, row0, rows_active);
      } else {
        consume<W, 64>(p, ring, full, empty, geo, g0, n0, n_k, row0, rows_active);
      }
    }
    if (p.splits == 1) {  // rows past the computed tiles are zero
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
      for (int i = threadIdx.x; i < (p.M - rows_active) * (kBN / 2);
           i += kConsumers * 128) {
        const int row = rows_active + i / (kBN / 2);
        const int col = n0 + (i % (kBN / 2)) * 2;
        if (col < p.N)
          *reinterpret_cast<__nv_bfloat162*>(p.out + static_cast<long long>(row) * p.N +
                                             col) = zero;
      }
    }
  }
}

// Sums the K-split partials in split order, scales, rounds; zero rows past
// the computed tiles. One thread per output column pair.
__global__ void reduce_kernel(const float* __restrict__ part,
                              const float* __restrict__ scale,
                              const int* __restrict__ total_ptr,
                              __nv_bfloat16* __restrict__ out, int M, int N,
                              int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long pairs = static_cast<long long>(M) * N / 2;
  if (i >= pairs) return;
  const int row = static_cast<int>(2 * i / N);
  const int col = static_cast<int>(2 * i % N);
  const int rows_active = active_rows(total_ptr, M);
  float v0 = 0.f, v1 = 0.f;
  if (row < rows_active) {
    for (int s = 0; s < splits; ++s) {
      const float2 p = *reinterpret_cast<const float2*>(
          part + (static_cast<long long>(s) * M + row) * N + col);
      v0 += p.x;
      v1 += p.y;
    }
    if (scale != nullptr) {
      v0 *= scale[col];
      v1 *= scale[col + 1];
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(out + 2 * i) = __floats2bfloat162_rn(v0, v1);
}

// A row-major [rows, cols] matrix of `elem`-byte values as a 2-D map (cols,
// rows) with boxes of box_cols x box_rows landing with the 128-byte swizzle;
// reads past either end are zeros.
bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
               int rows, int cols, int box_cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename W>
int launch(const void* x, const void* w, const void* scale, const void* total,
           void* out, void* part, int M, int N, int K, int splits, int k_per_split,
           cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const bool w_ok =
      sizeof(W) == 1
          ? encode_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kBN, kBK)
          : encode_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, 64, kBK);
  if (!w_ok || !encode_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kBK,
                          kRowTile)) {
    return -2;
  }
  cudaError_t err = allow_smem_once<ragged_kernel<W>>(kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const float*>(scale), static_cast<const int*>(total),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
                 M, N, K, k_per_split, splits};
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>(splits));
  ragged_kernel<W><<<grid, kThreads, kSmemBytes, stream>>>(xmap, wmap, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(M) * N / 2;
  reduce_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<const int*>(total), static_cast<__nv_bfloat16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tiling the host's split plan (ops/ragged_matmul.k_splits) must agree
// with: weight columns per block, K per ring stage, rows per tile and per
// pass, the most K splits of one column tile, the ring's bytes and the
// dynamic shared memory of a block.
extern "C" void k8s_ragged_tiling(int* bn, int* bk, int* row_tile, int* max_rows,
                                  int* max_splits, int* ring_bytes, int* smem_bytes) {
  *bn = kBN;
  *bk = kBK;
  *row_tile = kRowTile;
  *max_rows = kMaxRows;
  *max_splits = kMaxSplits;
  *ring_bytes = kRingBytes;
  *smem_bytes = kSmemBytes;
}

// x [M, K] bf16; w [K, N] int8 (w_int8 = 1, `scale` [N] f32) or bf16
// (w_int8 = 0, `scale` null); total a device int32; out [M, N] bf16; part an
// f32 workspace of splits * M * N (unused when splits == 1; only the active
// rows are written and read). K must be a multiple of 8 and N of 16 (int8)
// or 8 (bf16). Returns a cudaError_t code (0 on success); -2 when the tensor
// maps cannot be encoded, -3 for a split plan that is not whole K steps or
// has more than kMaxSplits splits.
extern "C" int k8s_ragged_matmul(const void* x, const void* w, const void* scale,
                                 const void* total, void* out, void* part, int M,
                                 int N, int K, int splits, int k_per_split,
                                 int w_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kMaxSplits || k_per_split <= 0 || k_per_split % kBK)
    return -3;
  if (M == 0 || N == 0) return 0;
  if (w_int8)
    return launch<int8_t>(x, w, scale, total, out, part, M, N, K, splits,
                          k_per_split, st);
  return launch<__nv_bfloat16>(x, w, scale, total, out, part, M, N, K, splits,
                               k_per_split, st);
}
