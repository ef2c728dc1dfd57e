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
//   products.
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
// helpers and that lookup are hopper.cuh's, shared with K3.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch_utils.cuh"

namespace {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
constexpr int kRows = 64 * kConsumers;          // query rows per block
constexpr int kKeys = 128;                      // keys per tile
constexpr int kStages = 3;
constexpr int kBoxBytes = kKeys * 128;  // one TMA box: kKeys rows of 64 bf16
constexpr float kNegInf = -1e30f;

template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return kKeys * HD * 2;
}

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  // the ring (K then V tile per stage), 1024 bytes to align it for the
  // 128-byte swizzle, and the full/empty barriers
  return kStages * 2 * tile_bytes<HD>() + 1024 + 2 * kStages * 8;
}

struct Params {
  const __nv_bfloat16* q;
  const int* prefix_len;
  float* o;  // outputs, or the split workspace (split-major)
  float* m;
  float* l;
  long long split_rows;  // rows of one split in m/l (B * n_kv * g * S)
  int B, S, n_kv, g, Sp, keys_per_split;
  float scale;
};

// K-major operand (the K tile for S = Q K^T): key rows of 128 bytes, groups
// of 8 rows 1024 bytes apart; a k-step of 16 head columns is 32 bytes along
// the row inside one box, the next box holds columns 64..127.
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (the V tile for O += P V, stored [key, hd]): a k-step of
// 16 keys is 16 rows (2048 bytes); 8-key groups are 1024 bytes apart (the
// stride offset) and the next 64 head columns are one box further (the
// leading offset).
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int j) {
  return sw128_desc(tile + j * 16 * 128, kBoxBytes, 1024);
}

// ---------------------------------------------------------------- consumer
constexpr float kLog2e = 1.4426950408889634f;

// Turn-taking of the two consumer warpgroups (named barriers 1 and 2; 0 is
// __syncthreads): a warpgroup waits for its turn before it issues a round
// of products and hands the turn over once they are issued, so one
// warpgroup's softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for the warpgroup's 64 rows x kKeys keys of one stage (issued,
// not waited for).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[kKeys / 2],
                                         const uint32_t (&qa)[HD / 16][4],
                                         uint32_t ktile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (kKeys == 128) {
      wgmma_n128<0>(s, qa[kk], k_desc(ktile, kk), kk > 0);
    } else {
      wgmma_n64<0>(s, qa[kk], k_desc(ktile, kk), kk > 0);
    }
  }
}

// O += P V for one stage's V tile (issued, not waited for).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[kKeys / 16][4],
                                         uint32_t vtile) {
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
    if constexpr (HD == 128) {
      wgmma_n128<1>(o, pa[j], v_desc(vtile, j), 1);
    } else {
      wgmma_n64<1>(o, pa[j], v_desc(vtile, j), 1);
    }
  }
}

// Online softmax of one tile of scores (keys start.. start + kKeys, those at
// or past k_end masked when MASKED), in place: s becomes P, m_run the new
// row maxima, rs this thread's share of the tile's row sums and alpha the
// factor that rescales what was summed before.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], int start,
                                             int k_end, int tq, float (&m_run)[2],
                                             float (&rs)[2], float (&alpha)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED && start + nb * 8 + 2 * tq + (e & 1) >= k_end) {
        s[nb * 4 + e] = kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nb * 4 + e]);
    }
  }
  float ml2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    alpha[h] = fast_exp2((m_run[h] - m_new) * kLog2e);
    m_run[h] = m_new;
    ml2[h] = m_new * kLog2e;
    rs[h] = 0.f;
  }
#pragma unroll
  for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float pr = fast_exp2(fmaf(s[nb * 4 + e], kLog2e, -ml2[h]));
      // a masked key gets exactly 0, never exp(-1e30 - -1e30) = 1
      if (MASKED && start + nb * 8 + 2 * tq + (e & 1) >= k_end) pr = 0.f;
      s[nb * 4 + e] = pr;
      rs[h] += pr;
    }
  }
}

// The tile's softmax, masked only where the tile crosses k_end.
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], int start,
                                             int k_end, int tq, float (&m_run)[2],
                                             float (&rs)[2], float (&alpha)[2]) {
  if (start + kKeys > k_end) {
    softmax_tile<true>(s, start, k_end, tq, m_run, rs, alpha);
  } else {
    softmax_tile<false>(s, start, k_end, tq, m_run, rs, alpha);
  }
}

// P as A fragments: the S accumulator layout is P's A-fragment layout.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kKeys / 16][4],
                                       const float (&s)[kKeys / 2]) {
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[j][r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
  }
}

// One warpgroup: 64 query rows (warp w owns 16; this thread the two rows
// lane/4 and lane/4 + 8, in the accumulator layout of m64nNk16). The tile
// loop is a two-deep software pipeline: Q.K^T of tile t and P.V of tile t-1
// are issued together, and tile t's softmax runs while P.V is still on the
// tensor cores.
template <int HD>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int wg,
                                        int k_begin, int k_end, int n_tiles) {
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int gq = lane / 4;  // accumulator row within the warp's 16
  const int tq = lane % 4;  // accumulator column pair
  const int kv = blockIdx.y;
  const long long n_rows = static_cast<long long>(p.B) * p.S * p.g;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kRows + wg * 64 + warp * 16 + gq;

  const __nv_bfloat16* qrow[2] = {nullptr, nullptr};
  long long ml[2] = {-1, -1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + 8 * h;
    if (r < n_rows) {
      const long long bs = r / p.g;  // b * S + s
      const int gi = static_cast<int>(r % p.g);
      const long long b = bs / p.S;
      const long long s = bs % p.S;
      qrow[h] = p.q + (bs * (p.n_kv * p.g) + kv * p.g + gi) * HD;
      ml[h] = ((b * p.n_kv + kv) * p.g + gi) * p.S + s;
    }
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this thread's share of the row sums

  if (n_tiles > 0) {
    // Q as A fragments, scaled in f32 then rounded to bf16 (the TPU
    // kernel's order); rows outside the problem read as zeros.
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
        if (qrow[h]) {
          lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow[h] + c));
          hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow[h] + c + 8));
        }
        qa[kk][h] = pack_bf16(lo.x * p.scale, lo.y * p.scale);
        qa[kk][2 + h] = pack_bf16(hi.x * p.scale, hi.y * p.scale);
      }
    }
    auto ktile = [&](int st) { return smem_u32(ring + st * 2 * tile_bytes<HD>()); };

    float s[kKeys / 2];
    uint32_t pa[kKeys / 16][4];
    float rs[2], alpha[2];
    // n_tiles + 1 rounds of issue; warpgroup 0 goes first, and each round
    // of one is matched by one of the other (the second warpgroup's last
    // round hands over nothing)
    if (wg == 1) turn_pass(wg);
    mbar_wait(&full[0], 0);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<HD>(s, qa, ktile(0));
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_operand(s);
    softmax_tile(s, k_begin, k_end, tq, m_run, rs, alpha);
    l_part[0] = rs[0];
    l_part[1] = rs[1];
    pack_p(pa, s);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int prev = (t - 1) % kStages;
      mbar_wait(&full[st], (t / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<HD>(s, qa, ktile(st));
      wgmma_commit();
      issue_pv<HD>(o, pa, ktile(prev) + tile_bytes<HD>());
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // Q.K^T of tile t is done; P.V of t-1 may run on
      fence_operand(s);
      softmax_tile(s, k_begin + t * kKeys, k_end, tq, m_run, rs, alpha);
      wgmma_wait<0>();
      fence_operand(o);
      // the stage goes back to the producer only after the P.V product
      // that reads it has completed
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int h = 0; h < 2; ++h) l_part[h] = l_part[h] * alpha[h] + rs[h];
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        o[nb * 4 + 0] *= alpha[0];
        o[nb * 4 + 1] *= alpha[0];
        o[nb * 4 + 2] *= alpha[1];
        o[nb * 4 + 3] *= alpha[1];
      }
      pack_p(pa, s);
    }
    const int last = (n_tiles - 1) % kStages;
    turn_wait(wg);
    wgmma_fence();
    issue_pv<HD>(o, pa, ktile(last) + tile_bytes<HD>());
    wgmma_commit();
    if (wg == 0) turn_pass(wg);
    wgmma_wait<0>();
    fence_operand(o);
    if (lane == 0) mbar_arrive(&empty[last]);
  }

  // Row sums across the four threads that share a row, then store.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_part[h] += __shfl_xor_sync(0xffffffff, l_part[h], 1);
    l_part[h] += __shfl_xor_sync(0xffffffff, l_part[h], 2);
  }
  const long long base = static_cast<long long>(blockIdx.z) * p.split_rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (ml[h] < 0) continue;
    float* orow = p.o + (base + ml[h]) * HD;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<float2*>(orow + nb * 8 + 2 * tq) =
          make_float2(o[nb * 4 + 2 * h], o[nb * 4 + 2 * h + 1]);
    }
    if (tq == 0) {
      p.m[base + ml[h]] = m_run[h];
      p.l[base + ml[h]] = l_part[h];
    }
  }
}

// Grid: (row tiles of 128, kv heads, key splits). Warpgroups 0..1 consume,
// warpgroup 2 produces (one thread issues the TMA loads).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    prefix_parts_kernel(__grid_constant__ const CUtensorMap kmap,
                        __grid_constant__ const CUtensorMap vmap, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * tile_bytes<HD>());
  uint64_t* empty = full + kStages;

  int plen = *p.prefix_len;
  plen = plen < 0 ? 0 : (plen > p.Sp ? p.Sp : plen);
  const int k_begin = blockIdx.z * p.keys_per_split;
  const int k_end = min(plen, k_begin + p.keys_per_split);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      const int kv = blockIdx.y;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * tile_bytes<HD>());
        unsigned char* kdst = ring + st * 2 * tile_bytes<HD>();
        unsigned char* vdst = kdst + tile_bytes<HD>();
        const int key = k_begin + t * kKeys;
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_3d(kdst + c * kBoxBytes, &kmap, &full[st], c * 64, kv, key);
          tma_load_3d(vdst + c * kBoxBytes, &vmap, &full[st], c * 64, kv, key);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<HD>(p, ring, full, empty, wg, k_begin, k_end, n_tiles);
  }
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
  constexpr int smem = smem_bytes<HD>();
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
