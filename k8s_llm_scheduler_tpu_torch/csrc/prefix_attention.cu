// K1: flash partials of suffix queries against ONE shared dense prefix KV.
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py
// _prefix_kernel (pl.pallas_call in flash_prefix_attention_parts). It runs in
// every layer of the chunked prefix prefill, the suffix prefill and every
// block-decode iteration of a decision wave.
//
// All B*S*g query rows of one kv head attend the same prefix keys, so they
// are flattened into one row axis (row = (b*S + s)*g + gi, the q tensor's own
// order) and tiled 64 rows to a block: each prefix K/V tile is read once per
// 64 query rows, whatever the batch. Keys at or past prefix_len (read from
// device memory) are never loaded. See flash_parts.cuh for the body and the
// bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/prefix_attention.py).

#include "flash_parts.cuh"
#include "launch_utils.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(flash::kThreads)
    prefix_parts_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ prefix_len, float* __restrict__ o,
                        float* __restrict__ m, float* __restrict__ l, int B, int S,
                        int n_kv, int g, int Sp, float scale) {
  const int kv = blockIdx.y;
  const long long n_rows = static_cast<long long>(B) * S * g;
  const long long row0 = static_cast<long long>(blockIdx.x) * flash::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const flash::RowMap map{S, n_kv, g};

  int plen = *prefix_len;
  plen = plen < 0 ? 0 : (plen > Sp ? Sp : plen);

  const __nv_bfloat16* qrow[2] = {nullptr, nullptr};
  float* orow[2] = {nullptr, nullptr};
  float* mrow[2] = {nullptr, nullptr};
  float* lrow[2] = {nullptr, nullptr};
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + warp * flash::kRowsPerWarp + lane / 4 + 8 * h;
    if (r < n_rows) {
      const long long bs = r / g;
      const int gi = static_cast<int>(r % g);
      const int b = static_cast<int>(bs / S);
      const int s = static_cast<int>(bs % S);
      qrow[h] = q + map.q_off(b, s, kv, gi, HD);
      const long long ml = map.ml_off(b, s, kv, gi);
      orow[h] = o + ml * HD;
      mrow[h] = m + ml;
      lrow[h] = l + ml;
    }
  }
  const int limit[2] = {plen, plen};
  const long long key_stride = static_cast<long long>(n_kv) * HD;
  flash::flash_rows<HD>(qrow[0], qrow[1], k + kv * HD, v + kv * HD, key_stride,
                        Sp, plen, plen, limit, scale, orow[0], orow[1],
                        mrow[0], mrow[1], lrow[0], lrow[1]);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* prefix_len,
           void* o, void* m, void* l, int B, int S, int n_kv, int g, int Sp,
           float scale, cudaStream_t stream) {
  constexpr int smem = flash::smem_bytes<HD>();
  cudaError_t err = allow_smem_once<prefix_parts_kernel<HD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(B) * S * g;
  dim3 grid(static_cast<unsigned>((n_rows + flash::kRows - 1) / flash::kRows),
            static_cast<unsigned>(n_kv));
  prefix_parts_kernel<HD><<<grid, flash::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(prefix_len),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), B,
      S, n_kv, g, Sp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t code (0 on success); -1 for an unsupported head dim.
extern "C" int k8s_flash_prefix_parts(const void* q, const void* k,
                                      const void* v, const void* prefix_len,
                                      void* o, void* m, void* l, int B, int S,
                                      int n_kv, int g, int Sp, int hd,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * S * g == 0) return 0;
  if (hd == 128)
    return launch<128>(q, k, v, prefix_len, o, m, l, B, S, n_kv, g, Sp, scale, st);
  if (hd == 64)
    return launch<64>(q, k, v, prefix_len, o, m, l, B, S, n_kv, g, Sp, scale, st);
  return -1;
}
