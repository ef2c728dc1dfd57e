// K1: flash partials of suffix queries against ONE shared dense prefix KV,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py
// _prefix_kernel (pl.pallas_call in flash_prefix_attention_parts). It runs in
// every layer of the chunked prefix prefill, the suffix prefill and every
// block-decode iteration of a decision wave.
//
// For every query row r and the keys j < prefix_len (read on the device):
//   m[r] = max_j s[r,j],  l[r] = sum_j exp(s[r,j] - m[r]),
//   o[r] = sum_j bf16(exp(s[r,j] - m[r])) * v[j],
//   s[r,j] = bf16(q[r] * hd^-0.5) . k[j]      (f32 accumulation)
// UNNORMALIZED, and m = -1e30, l = 0, o = 0 for a row with no valid key.
//
// Rows. All B*S*g query rows of one kv head attend the same prefix keys, so
// they are flattened into one row axis (row = (b*S + s)*g + gi, the q
// tensor's own order) and tiled 128 rows to a block; every K/V tile a block
// loads serves all 128.
//
// What bounds it, and what the design does about it.
// - Prefix chunks and the suffix prefill (thousands of rows per kv head) do
//   4*rows*keys*hd flops on every prefix byte: far above the card's ~295
//   flop/byte ridge, so the tensor-core rate bounds them. Both products are
//   wgmma (the only instruction with the full rate): S = Q.K^T with Q in
//   registers (scaled in f32, rounded to bf16 by the consumer threads) and
//   the K tile as a K-major shared-memory operand; O += P.V with P from the
//   S accumulator's registers and the V tile as an MN-major operand (the
//   transpose bit). Two consumer warpgroups of 64 rows share each tile (128
//   rows a block halves the L2 reads of 64-row blocks), and one producer
//   warp keeps 128-key K/V tiles arriving by TMA into a three-stage ring
//   with mbarriers, so the consumers never spend registers or instructions
//   on loads; `setmaxnreg` moves the producer's registers to the consumers.
//   The softmax, not the products, would otherwise idle the tensor cores,
//   so each warpgroup issues Q.K^T of tile t with P.V of tile t-1 and runs
//   tile t's softmax while P.V is in flight, and the two warpgroups take
//   turns issuing (named barriers), so one's softmax overlaps the other's
//   products. That body is flash_hopper.cuh's, shared with K2
//   (causal_attention.cu); this file adds the prefix's map, the grid and
//   the split combine.
// - Block decode (R*24*g = 384 or 768 rows per kv head) has too few rows
//   to fill 132 SMs: 3 or 6 row tiles times 8 kv heads. The host splits
//   the prefix's keys over a third grid axis (ops/prefix_attention.py
//   kv_splits, from shapes alone: prefix_len stays on the device), each
//   split writes f32 partials to a workspace, and a second kernel folds
//   them in split order (deterministic). Then the call is bound by its
//   work, not by one block walking every key tile in series: there the
//   one read of the prefix K/V (22.5 MB at 5,488 keys) and the operations
//   of the few rows take about as long as each other (operations lead by
//   1.3x at R = 4 and 2.6x at R = 8).
//
// Tiles at or past prefix_len are never requested; a split that starts
// past it writes the empty partials and exits. Rows past the end of the K/V
// buffer arrive zero-filled from TMA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/prefix_attention.py). The tensor
// maps are encoded on the host for every call (each layer's prefix has its
// own base address) with cuTensorMapEncodeTiled, looked up through the CUDA
// runtime so that the library needs no -lcuda; encoding is host-only work,
// so the call stays capturable in a CUDA graph. The mbarrier, TMA and wgmma
// helpers and that lookup are hopper.cuh's, shared with K2 and K3.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"
#include "launch_utils.cuh"

namespace {

using flash::kKeys;
using flash::kNegInf;
using flash::kRows;
using flash::kThreads;
using flash::Params;

// Grid: (row tiles of 128, kv heads, key splits); the block body is
// flash_hopper.cuh's.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    prefix_parts_kernel(__grid_constant__ const CUtensorMap kmap,
                        __grid_constant__ const CUtensorMap vmap, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  int plen = *p.len;
  plen = plen < 0 ? 0 : (plen > p.Sp ? p.Sp : plen);
  const int k_begin = blockIdx.z * p.keys_per_split;
  const int k_end = min(plen, k_begin + p.keys_per_split);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;
  flash::run_block<HD, false>(
      &kmap, &vmap, p, smem_raw, blockIdx.y, 0,
      static_cast<long long>(blockIdx.x) * kRows,
      static_cast<long long>(p.B) * p.S * p.g, k_begin, k_end, n_tiles,
      static_cast<long long>(blockIdx.z) * p.split_rows);
}

// Folds the splits' partials in split order: m = max m_s,
// l = sum l_s e^(m_s - m), o = sum o_s e^(m_s - m). One thread per four
// columns of a row; the result is still an unnormalized partial.
template <int HD>
__global__ void combine_kernel(const float* __restrict__ ws_o,
                               const float* __restrict__ ws_m,
                               const float* __restrict__ ws_l, float* __restrict__ o,
                               float* __restrict__ m, float* __restrict__ l,
                               long long rows, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = i / (HD / 4);
  const int c = static_cast<int>(i % (HD / 4)) * 4;
  if (row >= rows) return;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_m[s * rows + row]);
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ws_m[s * rows + row] - mx);
    lsum += ws_l[s * rows + row] * w;
    const float4 v = *reinterpret_cast<const float4*>(ws_o + (s * rows + row) * HD + c);
    acc.x += v.x * w;
    acc.y += v.y * w;
    acc.z += v.z * w;
    acc.w += v.w * w;
  }
  *reinterpret_cast<float4*>(o + row * HD + c) = acc;
  if (c == 0) {
    m[row] = mx;
    l[row] = lsum;
  }
}

// ------------------------------------------------------------------- host

// The prefix [Sp, n_kv, hd] as a 3-D map (hd, n_kv, Sp): one box is 64 head
// columns of kKeys keys of one kv head, landing with the 128-byte swizzle
// that the wgmma descriptors name. Keys past Sp read as zeros.
bool encode_prefix_map(CUtensorMap* map, const void* base, int Sp, int n_kv, int hd) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(n_kv),
                              static_cast<cuuint64_t>(Sp)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(n_kv) * hd * 2};
  const cuuint32_t box[3] = {64, 1, kKeys};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* prefix_len,
           void* o, void* m, void* l, void* ws, int B, int S, int n_kv, int g,
           int Sp, int splits, int keys_per_split, float scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!encode_prefix_map(&kmap, k, Sp, n_kv, HD) ||
      !encode_prefix_map(&vmap, v, Sp, n_kv, HD)) {
    return -2;
  }
  constexpr int smem = flash::smem_bytes<HD>();
  cudaError_t err = allow_smem_once<prefix_parts_kernel<HD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(B) * S * g;
  const long long out_rows = n_rows * n_kv;  // rows of o, m, l
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(prefix_len),
           static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
           out_rows, B, S, n_kv, g, Sp, keys_per_split, scale};
  float* ws_o = static_cast<float*>(ws);
  float* ws_m = ws_o + static_cast<long long>(splits) * out_rows * HD;
  float* ws_l = ws_m + static_cast<long long>(splits) * out_rows;
  if (splits > 1) {
    p.o = ws_o;
    p.m = ws_m;
    p.l = ws_l;
  }
  dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows),
            static_cast<unsigned>(n_kv), static_cast<unsigned>(splits));
  prefix_parts_kernel<HD><<<grid, kThreads, smem, stream>>>(kmap, vmap, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long threads = out_rows * (HD / 4);
  combine_kernel<HD><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      ws_o, ws_m, ws_l, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), out_rows, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tiling the host's key-split plan (ops/prefix_attention.kv_splits)
// must agree with: query rows of one kv head per block, keys per tile.
extern "C" void k8s_flash_prefix_tiling(int* rows, int* keys) {
  *rows = kRows;
  *keys = kKeys;
}

// Returns a cudaError_t code (0 on success); -1 for an unsupported head dim,
// -2 when the tensor maps cannot be encoded, -3 for a split plan that is not
// whole key tiles. `ws` is an f32 workspace of splits * B*n_kv*g*S * (hd + 2)
// values (unused when splits == 1); keys [s * keys_per_split,
// (s + 1) * keys_per_split) are split s's.
extern "C" int k8s_flash_prefix_parts(const void* q, const void* k, const void* v,
                                      const void* prefix_len, void* o, void* m,
                                      void* l, void* ws, int B, int S, int n_kv,
                                      int g, int Sp, int hd, int splits,
                                      int keys_per_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || keys_per_split <= 0 || keys_per_split % kKeys) return -3;
  if (B * S * g == 0) return 0;
  if (hd == 128)
    return launch<128>(q, k, v, prefix_len, o, m, l, ws, B, S, n_kv, g, Sp, splits,
                       keys_per_split, scale, st);
  if (hd == 64)
    return launch<64>(q, k, v, prefix_len, o, m, l, ws, B, S, n_kv, g, Sp, splits,
                      keys_per_split, scale, st);
  return -1;
}
