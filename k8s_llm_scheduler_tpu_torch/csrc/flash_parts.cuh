// Flash-attention partials (o, m, l) on Hopper with warp-level bf16 tensor
// core products (mma.sync m16n8k16, f32 accumulation).
//
// Shared body of the two kernels of the decision path:
//   prefix_attention.cu  — suffix queries against ONE shared dense prefix KV
//                          (replaces ops/pallas_prefix_attention.py
//                          _prefix_kernel, the TPU kernel behind
//                          flash_prefix_attention_parts);
//   causal_attention.cu  — causal self-attention inside a chunk with per-row
//                          valid lengths (replaces _causal_kernel, behind
//                          flash_causal_attention_parts).
//
// Both compute, for every query row r, the UNNORMALIZED partials over the
// keys j < limit(r):
//   m[r] = max_j s[r,j],  l[r] = sum_j exp(s[r,j] - m[r]),
//   o[r] = sum_j bf16(exp(s[r,j] - m[r])) * v[j],
//   s[r,j] = bf16(q[r] * hd^-0.5) . k[j]      (f32 accumulation)
// and m = -1e30, l = 0, o = 0 for a row with no valid key. The prefix kernel
// has limit(r) = prefix_len; the causal kernel min(lens[b], pos(r) + 1).
//
// Work split. One block of 4 warps owns 64 query rows of ONE kv head; each
// warp owns 16 rows. The rows of a block are the GQA group's heads of
// consecutive (batch, position) pairs, so every K/V tile loaded into shared
// memory serves all of them — the group shares the tile instead of reading
// the kv head once per query head. Key tiles of 64 stream through a
// two-stage cp.async ring; tiles at or past the block's largest limit are
// never loaded (the valid-length and causal skips), and a warp whose own
// rows end before a tile skips its products on that tile.
//
// What bounds it. The work is 4*rows*keys*hd flops over the q, K/V and f32
// partials' bytes. Against a long prefix that is far above the card's ~295
// flop/byte ridge, so the tensor-core rate bounds it; short causal chunks
// with mostly short rows are bound by writing the f32 partials. This first
// version uses mma.sync (the warp-level instruction, a fraction of the
// wgmma peak) with no producer warp. The limits are read from device
// memory, so no host sync is needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 64;                     // keys per tile
constexpr float kNegInf = -1e30f;

// Shared-memory bytes: 2 stages x (K, V) x kKeys rows of HD + 8 bf16 (the
// pad spreads a fragment's 8 rows over distinct banks).
template <int HD>
constexpr int smem_bytes() {
  return 2 * 2 * kKeys * (HD + 8) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  uint16_t a = *reinterpret_cast<uint16_t*>(&lo);
  uint16_t b = *reinterpret_cast<uint16_t*>(&hi);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
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

// Where the block's rows live. Row r of the block's range maps to
// (batch b, position s, group member gi); q is [B, S, n_kv*g, HD] and the
// outputs are o [B, n_kv, g, S, HD], m/l [B, n_kv, g, S].
struct RowMap {
  int S, n_kv, g;
  __device__ __forceinline__ long long q_off(int b, int s, int kv, int gi,
                                             int hd) const {
    return ((static_cast<long long>(b) * S + s) * (n_kv * g) + kv * g + gi) *
           hd;
  }
  __device__ __forceinline__ long long ml_off(int b, int s, int kv,
                                              int gi) const {
    return ((static_cast<long long>(b) * n_kv + kv) * g + gi) * S + s;
  }
};

// Loads one key tile [start, start + kKeys) of K and V into a stage.
// Keys at or past n_keys (the end of the buffer) are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                          const __nv_bfloat16* kbase,
                                          const __nv_bfloat16* vbase,
                                          long long key_stride, int start,
                                          int n_keys) {
  constexpr int kVecPerRow = HD / 8;  // 16-byte vectors per key row
  for (int i = threadIdx.x; i < kKeys * kVecPerRow; i += kThreads) {
    int row = i / kVecPerRow;
    int col = (i % kVecPerRow) * 8;
    int key = start + row;
    bool ok = key < n_keys;
    long long goff = ok ? static_cast<long long>(key) * key_stride + col : 0;
    cp_async16(ks + row * (HD + 8) + col, kbase + goff, ok);
    cp_async16(vs + row * (HD + 8) + col, vbase + goff, ok);
  }
}

// The whole block: `limit[i]` is the exclusive key limit of the warp's rows
// (i = 0 for the fragment row lane/4, i = 1 for lane/4 + 8), `block_limit`
// the largest over the block's rows, and `rows_ok`/`qrow`/`orow` locate the
// two rows this thread touches.
template <int HD>
__device__ __forceinline__ void flash_rows(
    const __nv_bfloat16* __restrict__ qrow0, const __nv_bfloat16* __restrict__ qrow1,
    const __nv_bfloat16* __restrict__ kbase, const __nv_bfloat16* __restrict__ vbase,
    long long key_stride, int n_keys, int block_limit, int warp_limit,
    const int limit[2], float scale, float* __restrict__ orow0,
    float* __restrict__ orow1, float* mrow0, float* mrow1, float* lrow0,
    float* lrow1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kStage = kKeys * (HD + 8);

  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;  // fragment row within the warp's 16
  const int tq = lane % 4;  // fragment column pair

  // Q as A fragments, scaled in f32 then rounded to bf16 (the TPU kernel's
  // order of operations). Rows outside the problem read as zeros.
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    int c = kk * 16 + 2 * tq;
    float q00 = 0.f, q01 = 0.f, q10 = 0.f, q11 = 0.f;
    float q02 = 0.f, q03 = 0.f, q12 = 0.f, q13 = 0.f;
    if (qrow0) {
      q00 = __bfloat162float(qrow0[c]) * scale;
      q01 = __bfloat162float(qrow0[c + 1]) * scale;
      q02 = __bfloat162float(qrow0[c + 8]) * scale;
      q03 = __bfloat162float(qrow0[c + 9]) * scale;
    }
    if (qrow1) {
      q10 = __bfloat162float(qrow1[c]) * scale;
      q11 = __bfloat162float(qrow1[c + 1]) * scale;
      q12 = __bfloat162float(qrow1[c + 8]) * scale;
      q13 = __bfloat162float(qrow1[c + 9]) * scale;
    }
    qa[kk][0] = pack_bf16(q00, q01);
    qa[kk][1] = pack_bf16(q10, q11);
    qa[kk][2] = pack_bf16(q02, q03);
    qa[kk][3] = pack_bf16(q12, q13);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = (block_limit + kKeys - 1) / kKeys;
  if (n_tiles > 0) {
    load_tile<HD>(smem, smem + kStage, kbase, vbase, key_stride, 0, n_keys);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = cur ^ 1;
      load_tile<HD>(smem + 2 * nxt * kStage, smem + (2 * nxt + 1) * kStage,
                    kbase, vbase, key_stride, (it + 1) * kKeys, n_keys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int start = it * kKeys;
    if (start < warp_limit) {
      const __nv_bfloat16* ks = smem + 2 * cur * kStage;
      const __nv_bfloat16* vs = ks + kStage;

      // S = Q K^T for this warp's 16 rows x 64 keys.
      float s[kKeys / 8][4];
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int nb = 0; nb < kKeys / 8; ++nb) {
          const __nv_bfloat16* kp = ks + (nb * 8 + gq) * (HD + 8) + kk * 16 + 2 * tq;
          uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
          uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
          mma16816(s[nb], qa[kk], b0, b1);
        }
      }

      // Mask, online softmax update (rows gq and gq + 8).
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = start + nb * 8 + 2 * tq + (e & 1);
          const int h = e >> 1;
          if (key >= limit[h]) s[nb][e] = kNegInf;
          mx[h] = fmaxf(mx[h], s[nb][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = __expf(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = start + nb * 8 + 2 * tq + (e & 1);
          const int h = e >> 1;
          const float p = key < limit[h] ? __expf(s[nb][e] - m_run[h]) : 0.f;
          s[nb][e] = p;
          rs[h] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_part[h] = l_part[h] * alpha[h] + rs[h];
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        o[nb][0] *= alpha[0];
        o[nb][1] *= alpha[0];
        o[nb][2] *= alpha[1];
        o[nb][3] *= alpha[1];
      }

      // O += P V: the S accumulator layout is already P's A-fragment layout.
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
        const __nv_bfloat16* v0 = vs + (j * 16 + 2 * tq) * (HD + 8) + gq;
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb) {
          const __nv_bfloat16* vp = v0 + nb * 8;
          uint32_t b0 = pack_raw(vp[0], vp[HD + 8]);
          uint32_t b1 = pack_raw(vp[8 * (HD + 8)], vp[9 * (HD + 8)]);
          mma16816(o[nb], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's load
  }

  // Row sums across the four threads that share a row, then store.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_part[h] += __shfl_xor_sync(0xffffffff, l_part[h], 1);
    l_part[h] += __shfl_xor_sync(0xffffffff, l_part[h], 2);
  }
  if (orow0) {
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<float2*>(orow0 + nb * 8 + 2 * tq) =
          make_float2(o[nb][0], o[nb][1]);
    }
    if (tq == 0) {
      *mrow0 = m_run[0];
      *lrow0 = l_part[0];
    }
  }
  if (orow1) {
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<float2*>(orow1 + nb * 8 + 2 * tq) =
          make_float2(o[nb][2], o[nb][3]);
    }
    if (tq == 0) {
      *mrow1 = m_run[1];
      *lrow1 = l_part[1];
    }
  }
}

}  // namespace flash
