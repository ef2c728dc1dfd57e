// K4: paged decode attention — one query token per sequence against that
// sequence's KV pages, walked through its page table up to its length,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/pallas_paged_attention.py
// _decode_kernel (pl.pallas_call in _paged_call, behind
// paged_decode_attention_pallas and paged_decode_attention_parts). The
// general-completion path runs it in every layer of every decode step: the
// partials mode for a slot's own tokens inside the chunked decode
// (models/llama.forward_decode_buffered), the normalized mode in
// forward_decode.
//
// Semantics (the Pallas kernel's): q is scaled by hd^-0.5 in f32, scores and
// the softmax are f32 (e^x on the special-function unit, ~2^-22 relative),
// k/v are converted to f32, query head kv*g + gi reads
// kv head kv. With len = clamp(seq_lens[b], 0, P * page_size) the partials
// are m = max_j s_j, l = sum_j exp(s_j - m), o = sum_j exp(s_j - m) v_j over
// the keys j < len; a sequence with len <= 0 reports exactly m = -1e30, l = 0,
// o = 0 and reads neither its table nor any page (the engine passes negative
// lengths for its trash row and idle slots). Normalized: o / max(l, 1e-30)
// in q's dtype (bf16).
//
// What bounds it. Each K/V byte of the valid pages is read once and used for
// 2*g flops (g = 4 at 8B): far below the CUDA cores' f32 ridge (~20
// flop/byte), so device-memory bandwidth bounds it, and the math stays in
// f32 on the CUDA cores as the reference has it (a wgmma tile of 64 rows
// would be 94% padding at g = 4). What the design does about the bytes:
//
// - Split pages over blocks. The grid is (split, kv head, sequence). The
//   host picks the number of splits from shapes alone (ops/paged_attention.py
//   paged_splits: one block for each SM), and each block finds its pages on
//   the device from len: pages [s*c, min((s+1)*c, n_pages)) with
//   c = max(ceil(n_pages / splits), min_pages), so the splits divide the
//   valid pages, never the table's width, and a split holds at least
//   min_pages (256 tokens): below that, one block's walk costs less than a
//   merge. Splits with no page exit at once.
// - Pages by TMA. The layer's cache is a 3-D tensor map (hd, n_kv,
//   num_pages*ps); one box is up to 64 token rows of one kv head, all hd
//   columns (no swizzle: a warp reads along a row, so the rows land dense).
//   One producer thread reads the split's table entries (its warp fetches
//   32 at a time) and keeps a ring of K/V stages in flight with full/empty
//   mbarriers (hopper.cuh): three stages of 128 token rows (192 KB at hd
//   128), one block an SM. A stage holds whole boxes: 128/ps pages when ps
//   <= 64, two 64-row boxes of a page whose size is a multiple of 64, else
//   one. The maps are encoded on the host per call, so the call stays
//   capturable in a CUDA graph.
// - Warps work on their own tokens. Each of the 8 consumer warps takes its
//   own batches of 64/G tokens of each stage (G = g rounded up to a power of
//   two), 64 (token, row) pairs a batch in two independent halves of 32, so
//   one half's products and shuffles overlap the other's. Lane = 16 * slot +
//   column group: the lane holds q of its hd/16 columns for every row in
//   registers, forms partial dot products for the pairs of its token slot,
//   and one transposing butterfly over the half-warp (15 shuffles) a half
//   leaves lane i with pair i's score. An online softmax per row follows;
//   the probabilities go through 64 floats of shared memory to every lane
//   for P.V. A warp keeps its own (m, l, o) in registers and releases a
//   stage by one arrival on its empty barrier. Only a batch that reaches
//   past the stage's valid rows is masked, and that choice is uniform
//   across the warp. The one block-wide step is the fold of the 8 warps'
//   partials through shared memory, in warp order.
// - Splits merge in one launch. With one split the block writes the output.
//   Otherwise each split writes (o, m, l) to an f32 workspace and takes a
//   ticket: one atomic add, with release and acquire at gpu scope, on a
//   counter per (sequence, kv head). The block that draws the last ticket
//   folds every split's partials in split order, whatever order they
//   arrived in, writes the partials or the normalized output, and sets the
//   counter back to 0 for the next launch (and every CUDA-graph replay).
//   The result is bitwise the same from run to run.
//
// What holds it (chip runs, PERF.md): at the general path's decode step (4
// pages a sequence, one split) the time is a chain of latencies (the
// length, the table entry, the first stage, a batch of math a stage, the
// fold) more than bytes; at 63 pages a sequence it streams at ~75% of the
// bytes bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/paged_attention.py).
// cuTensorMapEncodeTiled is looked up through the CUDA runtime (hopper.cuh),
// so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch_utils.cuh"

namespace {

constexpr int kWarps = 8;  // consumer warps
constexpr int kConsumerThreads = kWarps * 32;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kStageTokens = 128;                // K (and V) rows of a stage
constexpr int kBoxTokens = 64;                   // rows of one TMA box, at most
constexpr float kNegInf = -1e30f;

// The ring: 192 KB of K/V stages, one block an SM.
template <int HD>
struct Ring {
  static constexpr int kStages = HD == 128 ? 3 : 6;  // 64 or 32 KB each
  static constexpr int kRowsBytes = kStageTokens * HD * 2;  // K (or V) of a stage
  static constexpr int kStageBytes = 2 * kRowsBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
};

struct Params {
  const __nv_bfloat16* q;  // [B, n_kv * g, HD]
  const int* table;        // [B, P]
  const int* lens;         // [B]
  void* o;   // parts: f32 [B, n_kv, g, HD]; normalized: bf16 [B, n_kv * g, HD]
  float* m;  // parts: f32 [B, n_kv, g]
  float* l;
  // splits > 1: f32 o [splits][B * n_heads][HD], then m and l
  // [splits][B * n_heads]
  float* ws;
  int* tickets;  // [B * n_kv], 0 between launches
  int B, n_kv, g, ps, P, splits;
  int min_pages;  // fewest pages a split takes (below that, fewer splits)
  int box;        // token rows of one TMA box: min(ps, kBoxTokens)
  float scale;
};

// e^x as 2^(x log2 e) on the special-function unit: relative error ~2^-22,
// exactly 1 at x = 0 and exactly 0 for x <= -1e30 (an empty partial).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Named barrier 1 over the 256 consumer threads (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// N consecutive bf16 at `src` (global or shared; 8 * N-byte aligned) as f32.
template <int N>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* src, float (&f)[N]) {
  static_assert(N == 4 || N == 8, "4 or 8 columns a lane");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    w[0] = raw.x;
    w[1] = raw.y;
    w[2] = raw.z;
    w[3] = raw.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    w[0] = raw.x;
    w[1] = raw.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = f2.x;
    f[2 * i + 1] = f2.y;
  }
}

// One step of transpose_sum: lanes with bit W set keep the upper half of
// v[0, 2W), the others the lower half; each sends its partner (lane ^ W)
// the half it drops and adds the half it receives.
template <int W>
__device__ __forceinline__ void transpose_step(float (&v)[16], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffff, send, W);
  }
}

// Sums v[i] over each half-warp (16 lanes) for all 16 i at once and leaves
// lane i of the half with the sum of v[i] (15 shuffles; every index is a
// constant, so v stays in registers).
__device__ __forceinline__ float transpose_sum(float (&v)[16], int lane) {
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// One warp's batch of 64 / G token rows of a stage: the scores, the online
// softmax and P.V of its 64 (token, row) pairs, in two halves h of 32 pairs,
// pair i of half h = token h * 32 / G + i / G, row i % G (K rows at ks, V
// rows at vs; the first `valid` rows are keys, MASKED when that is fewer
// than all). The two halves' products and butterflies are independent, so
// they overlap; their softmax bookkeeping is shared. Lane = 16 * slot + cg:
// column group cg owns columns cg * CPL .. + CPL (CPL = HD / 16), and token
// slot `slot` the first or second half of each half's tokens. The lane's
// running state: m_run and l_run of row lane % G (every lane of a row
// agrees), and o[gi][c], its slot's share of the unnormalized output. `sp`
// is the warp's 64 floats of shared memory through which every lane reads
// the probabilities.
template <int HD, int G, bool MASKED>
__device__ __forceinline__ void attend(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                       int valid, const float (&q)[G][HD / 16],
                                       float (&o)[G][HD / 16], float& m_run, float& l_run,
                                       float* sp, int lane) {
  constexpr int CPL = HD / 16;
  constexpr int TH = 32 / G;  // tokens of one half
  constexpr int TS = 16 / G;  // tokens of one slot of a half
  const int cg = lane % 16, t0 = (lane / 16) * TS;
  float part[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      float kf[CPL];
      load_cols<CPL>(ks + (h * TH + t0 + t) * HD + cg * CPL, kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) d = fmaf(q[gi][c], kf[c], d);
        part[h][t * G + gi] = d;
      }
    }
  }
  // lane holds the scores of its pairs: token h * TH + lane / G, row lane % G
  float sc[2], pr[2];
  bool key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sc[h] = transpose_sum(part[h], lane);
    key[h] = !MASKED || h * TH + lane / G < valid;
    if (!key[h]) sc[h] = kNegInf;  // a row past the keys may hold any bits
  }
  float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
  for (int off = G; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
  const float m_new = fmaxf(m_run, mx);
#pragma unroll
  for (int h = 0; h < 2; ++h) pr[h] = key[h] ? fast_exp(sc[h] - m_new) : 0.f;
  float rs = pr[0] + pr[1];
#pragma unroll
  for (int off = G; off < 32; off <<= 1) rs += __shfl_xor_sync(0xffffffff, rs, off);
  const float alpha = fast_exp(m_run - m_new);
  l_run = l_run * alpha + rs;
  m_run = m_new;
  __syncwarp();  // the previous batch's probabilities have been read
  sp[lane] = pr[0];
  sp[32 + lane] = pr[1];
  __syncwarp();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const float a = __shfl_sync(0xffffffff, alpha, gi);
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[gi][c] *= a;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      const int tok = h * TH + t0 + t;
      // rows past the keys are never read (a uniform test for each half-warp)
      if (MASKED && tok >= valid) break;
      float vf[CPL], pp[G];
      load_cols<CPL>(vs + tok * HD + cg * CPL, vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) pp[gi] = sp[tok * G + gi];  // broadcast reads
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) o[gi][c] = fmaf(pp[gi], vf[c], o[gi][c]);
      }
    }
  }
}

// One atomic add on a split-merge counter, at gpu scope with release and
// acquire semantics: it publishes what the block stored before it (ordered
// by a block barrier) and sees what the splits with earlier tickets stored.
__device__ __forceinline__ int take_ticket(int* counter) {
  int t;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(t)
               : "l"(counter)
               : "memory");
  return t;
}

// Element c of query row `row` (b * n_heads + kv * g + gi) of the output.
template <int HD, bool NORM>
__device__ __forceinline__ void store_out(const Params& p, long long row, int c, float o,
                                          float m, float l) {
  if (NORM) {
    static_cast<__nv_bfloat16*>(p.o)[row * HD + c] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  } else {
    static_cast<float*>(p.o)[row * HD + c] = o;
    if (c == 0) {
      p.m[row] = m;
      p.l[row] = l;
    }
  }
}

// Folds n partials of the block's g query rows in order i = 0..n-1, 8 at a
// time: m = max_i m_i, l = sum_i l_i e^(m_i - m), o = sum_i o_i e^(m_i - m)
// (with n > 8, what is folded so far is rescaled to each new maximum).
// m_at(i, gi), l_at(i, gi) and o_at(i, gi, c) read partial i; every thread
// folds its own elements of the g x HD outputs and computes their rows'
// weights itself (the same arithmetic in every thread, so all agree), with
// the 24 loads of a round in flight together: each has a valid (clamped)
// address and nothing waits on one before the next is issued. Calls
// out(gi, c, o, m, l) for every output element.
template <int HD, typename MF, typename LF, typename OF, typename Out>
__device__ __forceinline__ void fold(int n, int g, MF m_at, LF l_at, OF o_at, Out out) {
  constexpr int kRound = 8;
  for (int idx = threadIdx.x; idx < g * HD; idx += kConsumerThreads) {
    const int gi = idx / HD, c = idx % HD;
    float mx = kNegInf, acc = 0.f, lsum = 0.f;
    for (int i0 = 0; i0 < n; i0 += kRound) {
      float mv[kRound], lv[kRound], ov[kRound];
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        const int i = min(i0 + k, n - 1);
        mv[k] = m_at(i, gi);
        lv[k] = l_at(i, gi);
        ov[k] = o_at(i, gi, c);
      }
      float m_new = mx;
#pragma unroll
      for (int k = 0; k < kRound; ++k) m_new = fmaxf(m_new, mv[k]);  // clamped: a repeat
      const float alpha = fast_exp(mx - m_new);
      acc *= alpha;
      lsum *= alpha;
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        if (i0 + k < n) {
          const float w = fast_exp(mv[k] - m_new);
          acc = fmaf(ov[k], w, acc);
          lsum = fmaf(lv[k], w, lsum);
        }
      }
      mx = m_new;
    }
    out(gi, c, acc, mx, lsum);
  }
}

template <int HD, int G, bool NORM>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel(__grid_constant__ const CUtensorMap kmap,
                        __grid_constant__ const CUtensorMap vmap, const Params p) {
  using R = Ring<HD>;
  constexpr int CPL = HD / 16;
  constexpr int TBW = 64 / G;  // tokens of one warp batch
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full[R::kStages], empty[R::kStages];
  __shared__ float sp[kWarps][64];  // each warp's batch probabilities
  __shared__ int ticket;

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_heads = p.n_kv * p.g;
  const long long row0 = static_cast<long long>(b) * n_heads + kv * p.g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int raw_len = p.lens[b];  // in flight while the barriers are set up
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int len = min(max(raw_len, 0), p.P * p.ps);
  const int n_pages = (len + p.ps - 1) / p.ps;
  const int per = max((n_pages + p.splits - 1) / p.splits, p.min_pages);  // pages a split
  const int n_splits = n_pages > 0 ? (n_pages + per - 1) / per : 1;
  if (split >= n_splits) return;
  if (len == 0) {  // no key: exactly m = -1e30, l = 0, o = 0; no page read
    for (int idx = threadIdx.x; idx < p.g * HD; idx += kThreads) {
      store_out<HD, NORM>(p, row0 + idx / HD, idx % HD, 0.f, kNegInf, 0.f);
    }
    return;
  }
  const int pg0 = split * per, pg1 = min(pg0 + per, n_pages);
  const int cpp = (p.ps + p.box - 1) / p.box;              // boxes a page
  // boxes a stage: as many as fill it where every box but a sequence's last
  // is full (pages of whole boxes), else one
  const int ups = p.ps % p.box == 0 ? kStageTokens / p.box : 1;
  const int last = min(len - (pg1 - 1) * p.ps, p.ps);      // keys of the last page
  const int n_units = (pg1 - pg0 - 1) * cpp + (last + p.box - 1) / p.box;
  const int n_stages = (n_units + ups - 1) / ups;
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int* table = p.table + static_cast<long long>(b) * p.P;
  // the producer's first 32 table entries and the consumers' q rows load
  // while the block waits for its barriers
  int entry = 0;
  float q[G][CPL], o[G][CPL];
  if (warp == kWarps) {
    entry = pg0 + lane < pg1 ? __ldg(table + pg0 + lane) : 0;
  } else {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) q[gi][c] = o[gi][c] = 0.f;
      if (gi < p.g) {  // rows past g (G is g rounded up) stay 0 and are never written
        load_cols<CPL>(p.q + (row0 + gi) * HD + (lane % 16) * CPL, q[gi]);
      }
    }
  }
  __syncthreads();

  if (warp == kWarps) {
    // Producer: box u of the split (page pg0 + u / cpp, rows (u % cpp) * box
    // on) goes to stage u / ups once the consumers have released it. The
    // warp holds the table entries of 32 pages at a time, one a lane; lane 0
    // issues the copies. Rows past the cache arrive as zeros.
    int base = 0;
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % R::kStages;
      const int u0 = i * ups, u1 = min(u0 + ups, n_units);
      mbar_wait(&empty[st], ((i / R::kStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[st], (u1 - u0) * p.box * HD * 2 * 2);
      unsigned char* kdst = ring + st * R::kStageBytes;
      for (int u = u0; u < u1; ++u) {
        const int pi = u / cpp;
        if (pi >= base + 32) {
          base += 32;
          entry = pg0 + base + lane < pg1 ? __ldg(table + pg0 + base + lane) : 0;
        }
        const int page = __shfl_sync(0xffffffff, entry, pi - base);
        if (lane == 0) {
          const int row = page * p.ps + (u % cpp) * p.box;
          const int off = (u - u0) * p.box * HD * 2;
          tma_load_3d(kdst + off, &kmap, &full[st], 0, kv, row);
          tma_load_3d(kdst + R::kRowsBytes + off, &vmap, &full[st], 0, kv, row);
        }
      }
    }
    return;
  }

  // Consumers.
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) q[gi][c] *= p.scale;
  }
  float m_run = kNegInf, l_run = 0.f;
  for (int i = 0; i < n_stages; ++i) {
    const int st = i % R::kStages;
    const int u0 = i * ups;
    const int j = u0 % cpp;  // box of its page
    const int tok0 = (pg0 + u0 / cpp) * p.ps + j * p.box;
    int nv = min(min(ups, n_units - u0) * p.box, len - tok0);  // valid rows
    if (ups == 1) nv = min(nv, p.ps - j * p.box);
    mbar_wait(&full[st], (i / R::kStages) & 1);
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(ring + st * R::kStageBytes);
    const __nv_bfloat16* vs = ks + kStageTokens * HD;
    for (int t0 = warp * TBW; t0 < nv; t0 += kWarps * TBW) {
      if (t0 + TBW <= nv) {
        attend<HD, G, false>(ks + t0 * HD, vs + t0 * HD, TBW, q, o, m_run, l_run, sp[warp],
                             lane);
      } else {
        attend<HD, G, true>(ks + t0 * HD, vs + t0 * HD, nv - t0, q, o, m_run, l_run,
                            sp[warp], lane);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // The two token slots' shares, then the warps' partials, merged in warp
  // order through the (now idle) ring.
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[gi][c] += __shfl_xor_sync(0xffffffff, o[gi][c], 16);
  }
  consumers_sync();
  float* sm_o = reinterpret_cast<float*>(ring);  // [kWarps][G][HD]
  float* sm_m = sm_o + kWarps * G * HD;          // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;
  if (lane < 16) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) sm_o[(warp * G + gi) * HD + lane * CPL + c] = o[gi][c];
    }
  }
  if (lane < G) {
    sm_m[warp * G + lane] = m_run;
    sm_l[warp * G + lane] = l_run;
  }
  consumers_sync();

  const long long rows = static_cast<long long>(p.B) * n_heads;
  float* ws_o = p.ws;
  float* ws_m = ws_o + p.splits * rows * HD;
  float* ws_l = ws_m + p.splits * rows;
  auto write_out = [&](int gi, int c, float ov, float mv, float lv) {
    store_out<HD, NORM>(p, row0 + gi, c, ov, mv, lv);
  };
  auto write_ws = [&](int gi, int c, float ov, float mv, float lv) {
    const long long r = split * rows + row0 + gi;
    ws_o[r * HD + c] = ov;
    if (c == 0) {
      ws_m[r] = mv;
      ws_l[r] = lv;
    }
  };
  auto warp_m = [&](int w, int gi) { return sm_m[w * G + gi]; };
  auto warp_l = [&](int w, int gi) { return sm_l[w * G + gi]; };
  auto warp_o = [&](int w, int gi, int c) { return sm_o[(w * G + gi) * HD + c]; };
  if (n_splits == 1) {
    fold<HD>(kWarps, p.g, warp_m, warp_l, warp_o, write_out);
    return;
  }
  fold<HD>(kWarps, p.g, warp_m, warp_l, warp_o, write_ws);

  // The ticket: the last split of this (sequence, kv head) to finish folds
  // every split's partials, in split order. The barrier orders the block's
  // workspace stores before thread 0's release; its acquire and the second
  // barrier order the other splits' stores before the loads below.
  consumers_sync();
  int* counter = p.tickets + static_cast<long long>(b) * p.n_kv + kv;
  if (threadIdx.x == 0) ticket = take_ticket(counter);
  consumers_sync();
  if (ticket != n_splits - 1) return;
  fold<HD>(
      n_splits, p.g, [&](int s, int gi) { return __ldcg(ws_m + s * rows + row0 + gi); },
      [&](int s, int gi) { return __ldcg(ws_l + s * rows + row0 + gi); },
      [&](int s, int gi, int c) { return __ldcg(ws_o + (s * rows + row0 + gi) * HD + c); },
      write_out);
  if (threadIdx.x == 0) *counter = 0;
}

// ------------------------------------------------------------------- host

// One layer's cache [num_pages, ps, n_kv, hd] as a 3-D map (hd, n_kv,
// num_pages * ps): one box is `box` token rows of one kv head, all hd
// columns, dense in shared memory. Rows past the cache read as zeros.
bool encode_page_map(CUtensorMap* map, const void* base, long long tokens, int n_kv, int hd,
                     int box) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(n_kv),
                              static_cast<cuuint64_t>(tokens)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(n_kv) * hd * 2};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(hd), 1, static_cast<cuuint32_t>(box)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int G, bool NORM>
int launch(const Params& p, const CUtensorMap& kmap, const CUtensorMap& vmap,
           cudaStream_t stream) {
  cudaError_t err = allow_smem_once<paged_decode_kernel<HD, G, NORM>>(Ring<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p.splits), static_cast<unsigned>(p.n_kv),
                  static_cast<unsigned>(p.B));
  paged_decode_kernel<HD, G, NORM><<<grid, kThreads, Ring<HD>::kSmem, stream>>>(kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool NORM>
int dispatch_g(const Params& p, const CUtensorMap& kmap, const CUtensorMap& vmap,
               cudaStream_t stream) {
  if (p.g == 1) return launch<HD, 1, NORM>(p, kmap, vmap, stream);
  if (p.g == 2) return launch<HD, 2, NORM>(p, kmap, vmap, stream);
  if (p.g <= 4) return launch<HD, 4, NORM>(p, kmap, vmap, stream);
  return launch<HD, 8, NORM>(p, kmap, vmap, stream);
}

template <int HD>
int dispatch(const Params& p, const void* k, const void* v, long long tokens, int normalize,
             cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!encode_page_map(&kmap, k, tokens, p.n_kv, HD, p.box) ||
      !encode_page_map(&vmap, v, tokens, p.n_kv, HD, p.box)) {
    return -2;
  }
  return normalize ? dispatch_g<HD, true>(p, kmap, vmap, stream)
                   : dispatch_g<HD, false>(p, kmap, vmap, stream);
}

}  // namespace

// q [B, n_kv*g, hd] bf16; k/v [num_pages, ps, n_kv, hd] bf16; table [B, P]
// int32; lens [B] int32. normalize = 1: o [B, n_kv*g, hd] bf16 (m, l null);
// normalize = 0: o [B, n_kv, g, hd], m and l [B, n_kv, g], all f32. `ws` is
// an f32 workspace of splits * B*n_kv*g * (hd + 2) values (null when splits
// is 1) and `tickets` B*n_kv int32 counters that are 0 before the call and
// are 0 again after it. Returns a cudaError_t code (0 on success); -1 for an
// unsupported head dim or group, -2 when the tensor maps cannot be encoded,
// -3 for a split count outside [1, P].
extern "C" int k8s_paged_decode(const void* q, const void* k, const void* v,
                                const void* table, const void* lens, void* o, void* m,
                                void* l, void* ws, void* tickets, int B, int n_kv, int g,
                                int ps, int P, int num_pages, int hd, int splits,
                                int min_pages, int normalize, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || g > 8 || (hd != 64 && hd != 128)) return -1;
  if (splits < 1 || splits > (P > 1 ? P : 1) || min_pages < 1) return -3;
  if (B * n_kv == 0) return 0;
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(table),
           static_cast<const int*>(lens), o, static_cast<float*>(m), static_cast<float*>(l),
           static_cast<float*>(ws), static_cast<int*>(tickets), B, n_kv, g, ps, P, splits,
           min_pages, ps < kBoxTokens ? ps : kBoxTokens, scale};
  const long long tokens = static_cast<long long>(num_pages) * ps;
  return hd == 128 ? dispatch<128>(p, k, v, tokens, normalize, st)
                   : dispatch<64>(p, k, v, tokens, normalize, st);
}
