// K3: ragged-M matmul of block decode, out = x[M, K] @ w[K, N] over only the
// first ceil(total / 64) * 64 rows; later rows are written as zeros.
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/ragged_matmul.py _kernel
// (pl.pallas_call in ragged_matmul). Block decode compacts each iteration's
// valid tokens to the front of its [R*F, D] activation; every projection and
// MLP matmul of the layer (wq, wk, wv, wo, w_gate, w_up, w_down) runs here
// with the valid-token count `total` read from device memory, so the work
// follows the real tokens and no host sync is needed.
//
// Weights are bf16, or int8 with a per-output-channel f32 scale. An int8
// weight tile is converted to bf16 in registers and staged in shared memory
// for the tensor cores; no bf16 copy of the weight exists in device memory.
// The product accumulates in f32
// and the scale multiplies the f32 sum once, before the single rounding to
// bf16 (the TPU kernel's order: x @ bf16(q), times scale, cast).
//
// Work split. One block of 8 warps owns a 128-column tile of w and a range
// of K; it keeps the output tile's rows (up to 192, three 64-row tiles) in
// registers, so each weight tile streams from device memory ONCE per call
// whatever the number of rows. Tiles of w (64 x 128) and of x (rows x 64)
// stream through a four-stage cp.async ring; an int8 tile is converted to
// bf16 in shared memory once, and every fragment is read with ldmatrix
// (.trans for w, which is stored [K, N]). Where N has fewer 128-column
// tiles than the card has SMs, K is split over blocks; the f32 partials go
// to a workspace and a second kernel sums them in a fixed order, scales,
// rounds and writes the zero rows. Rows past 192 (a wider batch) run as
// further passes over the weights.
//
// What bounds it. At decode the rows are few (M <= 192), so a call must read
// every weight byte once: 1 byte a weight for int8, 2 for bf16. With all 192
// rows valid the bf16 tensor-core rate is close to that bound too. This
// first version uses mma.sync (m16n8k16, the warp-level instruction), not
// wgmma, and no producer warp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/ragged_matmul.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_utils.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;       // rows per M-tile (the TPU kernel's bm)
constexpr int kMaxTiles = 3;  // M-tiles resident per pass over the weights
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 64;       // K per pipeline stage
constexpr int kStages = 4;
constexpr int kXStride = kBK + 8;  // bf16 per x row in shared memory
constexpr int kBStride = kBN + 8;  // bf16 per w row that fragments read

// Elements per w row of a stage as it lands (int8 raw or bf16); rows stay
// 16-byte aligned and the bf16 pad spreads ldmatrix rows over the banks.
template <typename W>
__host__ __device__ constexpr int w_stride() {
  return sizeof(W) == 1 ? kBN + 16 : kBStride;
}

template <typename W>
__host__ __device__ constexpr int stage_bytes() {
  return kMaxTiles * kBM * kXStride * 2 + kBK * w_stride<W>() * int(sizeof(W));
}

// Dynamic shared memory: the ring, plus for int8 the stage converted to bf16.
template <typename W>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<W>() + (sizeof(W) == 1 ? kBK * kBStride * 2 : 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give matrix i's
// row addresses. With .trans each lane gets a column pair instead of a row
// pair: a [k][n] tile read that way is mma's col-major B fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// An int8 stage [kBK][kBN] as bf16 (exact: |q| <= 127), 16 weights a thread
// per step: the convert happens in registers, once per weight per call.
__device__ __forceinline__ void convert_stage(const int8_t* raw, __nv_bfloat16* cvt) {
  constexpr int kChunks = kBN / 16;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const int4 v = *reinterpret_cast<const int4*>(raw + r * w_stride<int8_t>() + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = pack_bf16(static_cast<float>(b[2 * j]), static_cast<float>(b[2 * j + 1]));
    uint4* dst = reinterpret_cast<uint4*>(cvt + r * kBStride + c);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// d += a(16x16, row-major) * b(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows that get computed: every 64-row tile up to the one holding row
// total - 1, capped at M.
__device__ __forceinline__ int active_rows(const int* total_ptr, int M) {
  int total = *total_ptr;
  total = total < 0 ? 0 : (total > M ? M : total);
  const int rows = (total + kBM - 1) / kBM * kBM;
  return rows < M ? rows : M;
}

// One stage: x rows [row0, row0 + rows) x [k0, k0 + kBK), w rows
// [k0, k0 + kBK) x columns [n0, n0 + kBN). Outside the matrices: zeros.
template <typename W>
__device__ __forceinline__ void load_stage(__nv_bfloat16* xs, W* ws,
                                           const __nv_bfloat16* x, const W* w,
                                           int M, int N, int K, int row0,
                                           int rows, int k0, int n0) {
  constexpr int kXChunks = kBK / 8;  // 16-byte chunks per x row
  for (int i = threadIdx.x; i < rows * kXChunks; i += kThreads) {
    const int r = i / kXChunks;
    const int c = (i % kXChunks) * 8;
    const int gr = row0 + r, gk = k0 + c;
    const bool ok = gr < M && gk < K;
    const __nv_bfloat16* src = ok ? x + static_cast<long long>(gr) * K + gk : x;
    cp_async16(xs + r * kXStride + c, src, ok);
  }
  constexpr int kPer = 16 / int(sizeof(W));  // weights per 16-byte chunk
  constexpr int kWChunks = kBN / kPer;
  for (int i = threadIdx.x; i < kBK * kWChunks; i += kThreads) {
    const int r = i / kWChunks;
    const int c = (i % kWChunks) * kPer;
    const int gk = k0 + r, gn = n0 + c;
    const bool ok = gk < K && gn < N;
    const W* src = ok ? w + static_cast<long long>(gk) * N + gn : w;
    cp_async16(ws + r * w_stride<W>() + c, src, ok);
  }
}

template <typename W, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_kernel(const __nv_bfloat16* __restrict__ x, const W* __restrict__ w,
                  const float* __restrict__ scale, const int* __restrict__ total_ptr,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int M, int N, int K, int k_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_k = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int rows_active = active_rows(total_ptr, M);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_m = warp % 4;  // 16-row slice of each 64-row tile
  const int warp_n = warp / 4;  // 64-column half of the block's 128
  const int gq = lane / 4;
  const int tq = lane % 4;
  // ldmatrix row addresses: A rows (lane % 16) at k offset 8 * (lane / 16);
  // B k rows (lane % 8) + 8 * ((lane / 8) % 2) at n offset 8 * (lane / 16).
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;
  __nv_bfloat16* cvt = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + kStages * stage_bytes<W>());  // int8 only

  auto xs_of = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * stage_bytes<W>());
  };
  auto ws_of = [&](int s) {
    return reinterpret_cast<W*>(smem_raw + s * stage_bytes<W>() +
                                kMaxTiles * kBM * kXStride * 2);
  };

  for (int row0 = 0; row0 < rows_active; row0 += kMaxTiles * kBM) {
    const int rows = min(kMaxTiles * kBM, rows_active - row0);
    const int tiles = (rows + kBM - 1) / kBM;
    float acc[kMaxTiles][8][4];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        acc[t][nt][0] = acc[t][nt][1] = acc[t][nt][2] = acc[t][nt][3] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_k)
        load_stage<W>(xs_of(s), ws_of(s), x, w, M, N, K, row0, tiles * kBM,
                      k_begin + s * kBK, n0);
      cp_async_commit();
    }
    for (int it = 0; it < n_k; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage `it` landed; stage it - 1 is free to refill
      const int pre = it + kStages - 1;
      if (pre < n_k)
        load_stage<W>(xs_of(pre % kStages), ws_of(pre % kStages), x, w, M, N, K,
                      row0, tiles * kBM, k_begin + pre * kBK, n0);
      cp_async_commit();

      const __nv_bfloat16* xs = xs_of(it % kStages);
      const __nv_bfloat16* wb;
      if constexpr (sizeof(W) == 1) {
        convert_stage(ws_of(it % kStages), cvt);
        __syncthreads();  // the converted stage is complete
        wb = cvt;
      } else {
        wb = ws_of(it % kStages);
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t b[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // two 8-column tiles per ldmatrix
          uint32_t r[4];
          ldmatrix_x4_trans(r, wb + (kk * 16 + b_row) * kBStride + warp_n * 64 +
                                   np * 16 + b_col);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int t = 0; t < kMaxTiles; ++t) {
          if (t < tiles) {
            uint32_t a[4];
            ldmatrix_x4(a, xs + (t * kBM + warp_m * 16 + a_row) * kXStride + kk * 16 +
                               a_col);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) mma16816(acc[t][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is refilled by the next pass

    // Epilogue: rows gq and gq + 8 of each 16-row slice, column pairs 2*tq.
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t >= tiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + t * kBM + warp_m * 16 + gq + 8 * h;
        if (row >= rows_active) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = n0 + warp_n * 64 + nt * 8 + 2 * tq;
          if (col >= N) continue;  // N is a multiple of 8: pairs never straddle
          float v0 = acc[t][nt][2 * h];
          float v1 = acc[t][nt][2 * h + 1];
          if (kSplit) {
            *reinterpret_cast<float2*>(
                part + (static_cast<long long>(blockIdx.y) * M + row) * N + col) =
                make_float2(v0, v1);
          } else {
            if (scale != nullptr) {
              v0 *= scale[col];
              v1 *= scale[col + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<long long>(row) * N + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }

  if (!kSplit) {  // rows past the computed tiles are zero
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = threadIdx.x; i < (M - rows_active) * (kBN / 2); i += kThreads) {
      const int row = rows_active + i / (kBN / 2);
      const int col = n0 + (i % (kBN / 2)) * 2;
      if (col < N)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * N + col) =
            zero;
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

template <typename W>
int launch(const void* x, const void* w, const void* scale, const void* total,
           void* out, void* part, int M, int N, int K, int splits, int k_per_split,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<W>();
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>(splits));
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const W*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const auto* tp = static_cast<const int*>(total);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  cudaError_t err;
  if (splits == 1) {
    err = allow_smem_once<ragged_kernel<W, false>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ragged_kernel<W, false><<<grid, kThreads, smem, stream>>>(
        xp, wp, sp, tp, op, pp, M, N, K, k_per_split);
    return static_cast<int>(cudaGetLastError());
  }
  err = allow_smem_once<ragged_kernel<W, true>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_kernel<W, true><<<grid, kThreads, smem, stream>>>(xp, wp, sp, tp, op, pp, M,
                                                           N, K, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(M) * N / 2;
  reduce_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      pp, sp, tp, op, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16; w [K, N] int8 (w_int8 = 1, `scale` [N] f32) or bf16
// (w_int8 = 0, `scale` null); total a device int32; out [M, N] bf16; part an
// f32 workspace of splits * M * N (unused when splits == 1). K and N must be
// multiples of 8 (of 16 for int8). Returns a cudaError_t code (0 on success).
extern "C" int k8s_ragged_matmul(const void* x, const void* w, const void* scale,
                                 const void* total, void* out, void* part, int M,
                                 int N, int K, int splits, int k_per_split,
                                 int w_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (w_int8)
    return launch<int8_t>(x, w, scale, total, out, part, M, N, K, splits,
                          k_per_split, st);
  return launch<__nv_bfloat16>(x, w, scale, total, out, part, M, N, K, splits,
                               k_per_split, st);
}
