// K2: flash partials of causal self-attention inside a chunk, with per-row
// valid lengths.
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py
// _causal_kernel (pl.pallas_call in flash_causal_attention_parts). It runs in
// every layer of the suffix prefill and of the chunked prefix prefill.
//
// Query row r of (batch b, kv head) is (position s = r / g, group member
// gi = r % g): a 64-row block covers 64/g consecutive positions of the whole
// GQA group, which shares each K/V tile. Row r sees keys j < min(lens[b],
// s + 1); key tiles above the block's last position (the causal diagonal)
// or at/past lens[b] (read from device memory) are never loaded. See
// flash_parts.cuh for the body and the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/prefix_attention.py).

#include "flash_parts.cuh"
#include "launch_utils.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(flash::kThreads)
    causal_parts_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lens, float* __restrict__ o,
                        float* __restrict__ m, float* __restrict__ l, int S,
                        int n_kv, int g, float scale) {
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = S * g;
  const int row0 = blockIdx.x * flash::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const flash::RowMap map{S, n_kv, g};

  int len = lens[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int block_last = min(row0 + flash::kRows, n_rows) - 1;
  const int warp_first = row0 + warp * flash::kRowsPerWarp;
  const int warp_last = min(warp_first + flash::kRowsPerWarp, n_rows) - 1;
  const int block_limit = min(len, block_last / g + 1);
  const int warp_limit = warp_first < n_rows ? min(len, warp_last / g + 1) : 0;

  const __nv_bfloat16* qrow[2] = {nullptr, nullptr};
  float* orow[2] = {nullptr, nullptr};
  float* mrow[2] = {nullptr, nullptr};
  float* lrow[2] = {nullptr, nullptr};
  int limit[2] = {0, 0};
  for (int h = 0; h < 2; ++h) {
    const int r = warp_first + lane / 4 + 8 * h;
    if (r < n_rows) {
      const int s = r / g;
      const int gi = r % g;
      qrow[h] = q + map.q_off(b, s, kv, gi, HD);
      const long long ml = map.ml_off(b, s, kv, gi);
      orow[h] = o + ml * HD;
      mrow[h] = m + ml;
      lrow[h] = l + ml;
      limit[h] = min(len, s + 1);
    }
  }
  const long long key_stride = static_cast<long long>(n_kv) * HD;
  const long long base = static_cast<long long>(b) * S * key_stride + kv * HD;
  flash::flash_rows<HD>(qrow[0], qrow[1], k + base, v + base, key_stride, S,
                        block_limit, warp_limit, limit, scale, orow[0], orow[1],
                        mrow[0], mrow[1], lrow[0], lrow[1]);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* o, void* m, void* l, int B, int S, int n_kv, int g, float scale,
           cudaStream_t stream) {
  constexpr int smem = flash::smem_bytes<HD>();
  cudaError_t err = allow_smem_once<causal_parts_kernel<HD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((S * g + flash::kRows - 1) / flash::kRows),
            static_cast<unsigned>(n_kv), static_cast<unsigned>(B));
  causal_parts_kernel<HD><<<grid, flash::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), S,
      n_kv, g, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t code (0 on success); -1 for an unsupported head dim.
extern "C" int k8s_flash_causal_parts(const void* q, const void* k,
                                      const void* v, const void* lens, void* o,
                                      void* m, void* l, int B, int S, int n_kv,
                                      int g, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * S * g == 0) return 0;
  if (hd == 128) return launch<128>(q, k, v, lens, o, m, l, B, S, n_kv, g, scale, st);
  if (hd == 64) return launch<64>(q, k, v, lens, o, m, l, B, S, n_kv, g, scale, st);
  return -1;
}
