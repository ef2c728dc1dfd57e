// The flash-attention body of K1 (prefix_attention.cu) and K2
// (causal_attention.cu) on Hopper (sm_90a): a producer warp feeds 128-key
// K/V tiles by TMA into a three-stage ring, and two consumer warpgroups of
// 64 query rows run both products with wgmma.
//
// For every query row r and the keys j < k_end(r) of the tiles a block
// walks, the UNNORMALIZED partials
//   m[r] = max_j s[r,j],  l[r] = sum_j exp(s[r,j] - m[r]),
//   o[r] = sum_j bf16(exp(s[r,j] - m[r])) * v[j],
//   s[r,j] = bf16(q[r] * hd^-0.5) . k[j]      (f32 accumulation)
// with m = -1e30, l = 0, o = 0 for a row with no valid key.
//
// Rows are the q tensor's own order flattened, r = (b*S + s)*g + gi, and a
// block owns 128 of them under one kv head. K1 (CAUSAL = false) has one key
// limit for every row (prefix_len, or the end of its key split) and keys
// from a 3-D map of the shared prefix [Sp, n_kv, hd]; K2 (CAUSAL = true)
// keeps a block inside one batch row b, gives row r the limit
// min(lens[b], s + 1), and reads keys from a 4-D map of the chunk
// [B, S, n_kv, hd].
//
// The rest is shared: the S accumulator is P's A fragment; each warpgroup
// issues Q.K^T of tile t with P.V of tile t-1 and runs tile t's softmax
// while P.V is in flight; the two warpgroups take turns issuing (named
// barriers), so one's softmax overlaps the other's products; a tile
// takes the masked softmax only where some row of the warpgroup ends
// inside it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
constexpr int kRows = 64 * kConsumers;            // query rows per block
constexpr int kKeys = 128;                        // keys per tile
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
  const int* len;  // K1: prefix_len (one value); K2: lens [B]
  float* o;        // outputs, or K1's split workspace (split-major)
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

// Online softmax of one tile of scores (keys start.. start + kKeys; for
// MASKED, those at or past the row's k_end[h] masked, h = 0, 1 the thread's
// two rows), in place: s becomes P, m_run the new row maxima, rs this
// thread's share of the tile's row sums and alpha the factor that rescales
// what was summed before. A row with every key of the tile masked keeps its
// m and l (alpha = 1, rs = 0).
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], int start,
                                             const int (&k_end)[2], int tq,
                                             float (&m_run)[2], float (&rs)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED && start + nb * 8 + 2 * tq + (e & 1) >= k_end[e >> 1]) {
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
      if (MASKED && start + nb * 8 + 2 * tq + (e & 1) >= k_end[h]) pr = 0.f;
      s[nb * 4 + e] = pr;
      rs[h] += pr;
    }
  }
}

// The tile's softmax, masked only where the tile reaches past mask_from,
// the smallest k_end among the warpgroup's rows (uniform across it).
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], int start,
                                             int mask_from, const int (&k_end)[2],
                                             int tq, float (&m_run)[2],
                                             float (&rs)[2], float (&alpha)[2]) {
  if (start + kKeys > mask_from) {
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

// One warpgroup: 64 query rows from block_row0 + 64 * wg (warp w owns 16;
// this thread the two rows lane/4 and lane/4 + 8, in the accumulator layout
// of m64nNk16); rows at or past row_end are outside the problem. The tile
// loop is a two-deep software pipeline: Q.K^T of tile t and P.V of tile t-1
// are issued together, and tile t's softmax runs while P.V is still on the
// tensor cores. Keys are k_begin + t * kKeys; a row's keys end at k_end, or
// for CAUSAL at min(k_end, s + 1). Results go to row out_base + (the row's
// place in m/l).
template <int HD, bool CAUSAL>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int wg,
                                        int kv, long long block_row0,
                                        long long row_end, int k_begin, int k_end,
                                        int n_tiles, long long out_base) {
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int gq = lane / 4;  // accumulator row within the warp's 16
  const int tq = lane % 4;  // accumulator column pair
  const long long row0 = block_row0 + wg * 64 + warp * 16 + gq;

  const __nv_bfloat16* qrow[2] = {nullptr, nullptr};
  long long ml[2] = {-1, -1};
  int row_k_end[2] = {k_end, k_end};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + 8 * h;
    if (r < row_end) {
      const long long bs = r / p.g;  // b * S + s
      const int gi = static_cast<int>(r % p.g);
      const long long b = bs / p.S;
      const long long s = bs % p.S;
      qrow[h] = p.q + (bs * (p.n_kv * p.g) + kv * p.g + gi) * HD;
      ml[h] = ((b * p.n_kv + kv) * p.g + gi) * p.S + s;
      if constexpr (CAUSAL) row_k_end[h] = min(k_end, static_cast<int>(s) + 1);
    }
  }
  // The smallest limit among the warpgroup's rows is its first row's: a
  // tile wholly below it takes the unmasked softmax.
  int mask_from = k_end;
  if constexpr (CAUSAL) {
    const long long first = block_row0 + wg * 64;
    if (first < row_end) {
      mask_from = min(k_end, static_cast<int>((first / p.g) % p.S) + 1);
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
    softmax_tile(s, k_begin, mask_from, row_k_end, tq, m_run, rs, alpha);
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
      softmax_tile(s, k_begin + t * kKeys, mask_from, row_k_end, tq, m_run, rs, alpha);
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (ml[h] < 0) continue;
    float* orow = p.o + (out_base + ml[h]) * HD;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<float2*>(orow + nb * 8 + 2 * tq) =
          make_float2(o[nb * 4 + 2 * h], o[nb * 4 + 2 * h + 1]);
    }
    if (tq == 0) {
      p.m[out_base + ml[h]] = m_run[h];
      p.l[out_base + ml[h]] = l_part[h];
    }
  }
}

// ---------------------------------------------------------------- producer
// One thread keeps the ring full: tile t (keys k_begin + t * kKeys of kv
// head kv, and for CAUSAL of batch row b) goes to stage t % kStages once the
// consumers have released it. K1's map is 3-D (hd, n_kv, Sp), K2's 4-D
// (hd, n_kv, S, B); keys past the buffer arrive as zeros.
template <int HD, bool CAUSAL>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int kv, int b, int k_begin,
                                        int n_tiles) {
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
    mbar_expect_tx(&full[st], 2 * tile_bytes<HD>());
    unsigned char* kdst = ring + st * 2 * tile_bytes<HD>();
    unsigned char* vdst = kdst + tile_bytes<HD>();
    const int key = k_begin + t * kKeys;
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      if constexpr (CAUSAL) {
        tma_load_4d(kdst + c * kBoxBytes, kmap, &full[st], c * 64, kv, key, b);
        tma_load_4d(vdst + c * kBoxBytes, vmap, &full[st], c * 64, kv, key, b);
      } else {
        tma_load_3d(kdst + c * kBoxBytes, kmap, &full[st], c * 64, kv, key);
        tma_load_3d(vdst + c * kBoxBytes, vmap, &full[st], c * 64, kv, key);
      }
    }
  }
}

// A block's whole run: the barriers, then warpgroups 0..1 consume and
// warpgroup 2 produces (one thread issues the TMA loads). `smem` is the
// kernel's dynamic shared memory (smem_bytes<HD>()).
template <int HD, bool CAUSAL>
__device__ __forceinline__ void run_block(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          const Params& p, unsigned char* smem, int kv,
                                          int b, long long block_row0, long long row_end,
                                          int k_begin, int k_end, int n_tiles,
                                          long long out_base) {
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * tile_bytes<HD>());
  uint64_t* empty = full + kStages;

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
      produce<HD, CAUSAL>(kmap, vmap, ring, full, empty, kv, b, k_begin, n_tiles);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<HD, CAUSAL>(p, ring, full, empty, wg, kv, block_row0, row_end, k_begin,
                        k_end, n_tiles, out_base);
  }
}

}  // namespace flash
