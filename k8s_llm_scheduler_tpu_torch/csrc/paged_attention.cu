// K4: paged decode attention — one query token per sequence against that
// sequence's KV pages, walked through its page table up to its length.
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
// the softmax are f32, k/v are converted to f32, query head kv*g + gi reads
// kv head kv. With len = clamp(seq_lens[b], 0, P * page_size) the partials
// are m = max_j s_j, l = sum_j exp(s_j - m), o = sum_j exp(s_j - m) v_j over
// the keys j < len; a sequence with len <= 0 reports exactly m = -1e30, l = 0,
// o = 0 (the engine passes negative lengths for its trash row and idle
// slots). Normalized: o / max(l, 1e-30) in q's dtype (bf16).
//
// Work split. One block of 8 warps per (kv head, sequence) holds the g query
// rows of that kv head and walks the sequence's pages in order, up to
// ceil(len / page_size) of them (read on the device: no host sync). Each
// page's K and V rows of this kv head stream into shared memory through a
// two-stage cp.async ring, so the next page loads while this one is used.
// Per page: every (token, row) score is a dot product over hd on the CUDA
// cores, one warp per row then updates the running max and sum and turns
// scores into probabilities, and every thread accumulates two output
// elements of P.V. g = 4 rows is too few for a tensor-core tile, and the
// Pallas kernel does this math in f32 anyway.
//
// What bounds it. Each K/V byte of the valid pages is read once and used
// for 2*g flops: far below the card's flop/byte ridge, so device-memory
// bandwidth bounds it. This first version gives one block to each (kv head,
// sequence): with few sequences fewer blocks than SMs run, and a page's
// loads overlap only the previous page's math.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/paged_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_utils.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // query rows per kv head (one warp each)
constexpr float kNegInf = -1e30f;

template <int HD>
__host__ __device__ constexpr int kv_stride() {
  return HD + 8;  // bf16 per K/V row in shared memory (bank spread)
}

template <int HD>
__host__ __device__ constexpr int q_stride() {
  return HD + 4;  // f32 per q row in shared memory (bank spread)
}

// Dynamic shared memory: 2 stages x (K, V) x ps rows, then q [kMaxG][HD + 4]
// f32 and the scores/probabilities [kMaxG][ps] f32.
template <int HD>
__host__ __device__ constexpr int smem_bytes(int ps) {
  return 2 * 2 * ps * kv_stride<HD>() * 2 + kMaxG * q_stride<HD>() * 4 +
         kMaxG * ps * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K and V rows of kv head `kv` for the ps tokens of `page` into one stage.
template <int HD>
__device__ __forceinline__ void load_page(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, int page,
                                          int ps, int n_kv, int kv) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ps * kChunks; i += kThreads) {
    const int t = i / kChunks;
    const int c = (i % kChunks) * 8;
    const long long off =
        ((static_cast<long long>(page) * ps + t) * n_kv + kv) * HD + c;
    cp_async16(ks + t * kv_stride<HD>() + c, k + off);
    cp_async16(vs + t * kv_stride<HD>() + c, v + off);
  }
}

template <int HD, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ page_table,
                        const int* __restrict__ seq_lens, void* __restrict__ o_out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int n_kv, int g, int ps, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv_smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int stage = ps * kv_stride<HD>();  // bf16 per K (or V) stage
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * 2 * stage * 2);
  float* ss = qs + kMaxG * q_stride<HD>();
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_heads = n_kv * g;

  int len = seq_lens[b];
  len = len < 0 ? 0 : (len > P * ps ? P * ps : len);
  const int n_pages = (len + ps - 1) / ps;
  const int* table = page_table + static_cast<long long>(b) * P;

  if (n_pages > 0) {
    load_page<HD>(kv_smem, kv_smem + stage, k, v, table[0], ps, n_kv, kv);
    cp_async_commit();
  }
  // q rows of this kv head, scaled in f32 (the Pallas kernel's order).
  for (int i = threadIdx.x; i < g * HD; i += kThreads) {
    const int gi = i / HD, d = i % HD;
    qs[gi * q_stride<HD>() + d] =
        __bfloat162float(q[(static_cast<long long>(b) * n_heads + kv * g + gi) * HD + d]) *
        scale;
  }
  if (threadIdx.x < kMaxG) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }

  // Each thread owns up to two (row, column pair) outputs of P.V.
  constexpr int kPairs = HD / 2;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int p = 0; p < n_pages; ++p) {
    const int cur = p & 1;
    if (p + 1 < n_pages) {
      const int nxt = cur ^ 1;
      load_page<HD>(kv_smem + 2 * nxt * stage, kv_smem + (2 * nxt + 1) * stage, k, v,
                    table[p + 1], ps, n_kv, kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv_smem + 2 * cur * stage;
    const __nv_bfloat16* vs = ks + stage;
    const int valid = min(ps, len - p * ps);

    // Scores s[gi][t] = q_gi . k_t (f32) for the page's valid tokens.
    for (int i = threadIdx.x; i < valid * g; i += kThreads) {
      const int t = i / g, gi = i % g;
      const __nv_bfloat16* kr = ks + t * kv_stride<HD>();
      const float* qr = qs + gi * q_stride<HD>();
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 q0 = *reinterpret_cast<const float4*>(qr + c);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + c + 4);
        const float2 k0 = __bfloat1622float2(kp[0]);
        const float2 k1 = __bfloat1622float2(kp[1]);
        const float2 k2 = __bfloat1622float2(kp[2]);
        const float2 k3 = __bfloat1622float2(kp[3]);
        dot += q0.x * k0.x + q0.y * k0.y + q0.z * k1.x + q0.w * k1.y;
        dot += q1.x * k2.x + q1.y * k2.y + q1.z * k3.x + q1.w * k3.y;
      }
      ss[gi * ps + t] = dot;
    }
    __syncthreads();

    // Online softmax update, one warp per row.
    for (int gi = warp; gi < g; gi += kWarps) {
      float* sr = ss + gi * ps;
      float mx = kNegInf;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float pr = expf(sr[t] - m_new);
        sr[t] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffff, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V for this thread's outputs.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int item = threadIdx.x + j * kThreads;
      if (item < g * kPairs) {
        const int gi = item / kPairs;
        const int c = (item % kPairs) * 2;
        const float* pr = ss + gi * ps;
        float a0 = acc[j][0] * alpha_s[gi];
        float a1 = acc[j][1] * alpha_s[gi];
        for (int t = 0; t < valid; ++t) {
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vs + t * kv_stride<HD>() + c));
          a0 += pr[t] * vv.x;
          a1 += pr[t] * vv.y;
        }
        acc[j][0] = a0;
        acc[j][1] = a1;
      }
    }
    __syncthreads();  // the stage and the scores are rewritten next page
  }
  __syncthreads();  // m_s/l_s of an empty sequence: written above, read below

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int item = threadIdx.x + j * kThreads;
    if (item < g * kPairs) {
      const int gi = item / kPairs;
      const int c = (item % kPairs) * 2;
      const long long row = static_cast<long long>(b) * n_heads + kv * g + gi;
      if (kNormalize) {
        const float inv = 1.f / fmaxf(l_s[gi], 1e-30f);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o_out) +
                                           row * HD + c) =
            __floats2bfloat162_rn(acc[j][0] * inv, acc[j][1] * inv);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(o_out) + row * HD + c) =
            make_float2(acc[j][0], acc[j][1]);
      }
    }
  }
  if (!kNormalize && threadIdx.x < g) {
    const long long row = static_cast<long long>(b) * n_heads + kv * g + threadIdx.x;
    m_out[row] = m_s[threadIdx.x];
    l_out[row] = l_s[threadIdx.x];
  }
}

template <int HD, bool kNormalize>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lens, void* o, void* m, void* l, int B, int n_kv, int g,
           int ps, int P, float scale, cudaStream_t stream) {
  const int smem = smem_bytes<HD>(ps);
  cudaError_t err = allow_smem_once<paged_decode_kernel<HD, kNormalize>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_kv), static_cast<unsigned>(B));
  paged_decode_kernel<HD, kNormalize><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(table),
      static_cast<const int*>(lens), o, static_cast<float*>(m),
      static_cast<float*>(l), n_kv, g, ps, P, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch(const void* q, const void* k, const void* v, const void* table,
             const void* lens, void* o, void* m, void* l, int B, int n_kv, int g,
             int ps, int P, int normalize, float scale, cudaStream_t stream) {
  if (normalize)
    return launch<HD, true>(q, k, v, table, lens, o, m, l, B, n_kv, g, ps, P, scale,
                            stream);
  return launch<HD, false>(q, k, v, table, lens, o, m, l, B, n_kv, g, ps, P, scale,
                           stream);
}

}  // namespace

// Shared-memory bytes the kernel needs for head dim hd and page size ps
// (the wrapper refuses pages that do not fit).
extern "C" int k8s_paged_decode_smem(int hd, int ps) {
  if (hd == 128) return smem_bytes<128>(ps);
  if (hd == 64) return smem_bytes<64>(ps);
  return -1;
}

// q [B, n_kv*g, hd] bf16; k/v [num_pages, ps, n_kv, hd] bf16; table [B, P]
// int32; lens [B] int32. normalize = 1: o [B, n_kv*g, hd] bf16 (m, l null);
// normalize = 0: o [B, n_kv, g, hd], m and l [B, n_kv, g], all f32.
// Returns a cudaError_t code (0 on success); -1 for an unsupported head dim.
extern "C" int k8s_paged_decode(const void* q, const void* k, const void* v,
                                const void* table, const void* lens, void* o,
                                void* m, void* l, int B, int n_kv, int g, int ps,
                                int P, int hd, int normalize, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * n_kv * g == 0) return 0;
  if (hd == 128)
    return dispatch<128>(q, k, v, table, lens, o, m, l, B, n_kv, g, ps, P, normalize,
                         scale, st);
  if (hd == 64)
    return dispatch<64>(q, k, v, table, lens, o, m, l, B, n_kv, g, ps, P, normalize,
                        scale, st);
  return -1;
}
