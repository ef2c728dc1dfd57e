// K2: flash partials of causal self-attention inside a chunk, with a valid
// length per batch row, written for Hopper (sm_90a).
//
// Replaces the TPU kernel k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py
// _causal_kernel (pl.pallas_call in flash_causal_attention_parts). It runs in
// every layer of the chunked prefix prefill, of the suffix prefill and of
// the general path's paged admission.
//
// Row s of batch row b sees the keys j < min(lens[b], s + 1) of its own
// chunk; lens is read from device memory and clamped to [0, S]. Outputs are
// UNNORMALIZED (o, m, l) as K1's, and a row with no valid key reports
// m = -1e30, l = 0, o = 0.
//
// Rows. Query row r of (batch row b, kv head) is position s = r / g, group
// member gi = r % g (the q tensor's own order): a block owns 128 rows, 128/g
// consecutive positions of the whole GQA group, which shares every K/V tile
// the block loads. Keys belong to one sequence, so a block never spans two
// batch rows.
//
// What bounds each of the path's shapes, and what the design does about it.
// - Prefix chunks, q[1,2048] (lens 2048 and the last chunk's remainder):
//   S(S+1)/2 key pairs per head, 34 GFLOP at Llama-3.1-8B width against
//   ~60 MB of q, K/V and f32 partials, so the tensor-core rate bounds it.
//   The body is K1's (flash_hopper.cuh): wgmma for both products, a
//   producer warp keeping 128-key tiles arriving by TMA in a three-stage
//   ring, two consumer warpgroups taking turns so that one's softmax
//   overlaps the other's products. The causal limit is per row: a block
//   walks only the tiles below its last row's limit (tiles above the
//   diagonal, or at or past lens[b], are never requested), and a
//   warpgroup takes the masked softmax only on a tile that some of its
//   rows end inside, the diagonal one.
//   The triangle gives blocks 1 to S/128 tiles of work; launched in row
//   order the heaviest would start last and set the tail. So the linear
//   block index walks each batch row's row tiles from the last (heaviest)
//   down, every kv head of a row tile together. Batch rows go in order:
//   their lengths live on the device, so the host cannot rank them, and a
//   batch row kept together puts the live rows of a mostly empty batch
//   (a single decision's q[4,256] holds one) into the first wave.
// - Suffix prefills, q[4,256] and q[8,256] (and the paged admission): one
//   or two key tiles per block, and the f32 partial o (B*S*32*128*4 bytes:
//   33.5 MB at q[8,256]) is most of the bytes, so writing it bounds the
//   call. Each q, K and V byte is read once per block that needs it (the
//   group shares the tiles) and o, m and l are written once, from
//   registers.
//
// Keys come through a 4-D tensor map of k/v [B, S, n_kv, hd] (box: 64 head
// columns x 1 kv head x 128 keys x 1 batch row, 128-byte swizzle), so a tile
// never straddles two sequences and keys past S arrive as zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC; bound to Python with ctypes (ops/prefix_attention.py). The maps
// are encoded on the host for every call, so the call stays capturable in
// a CUDA graph.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"
#include "launch_utils.cuh"

namespace {

using flash::kKeys;
using flash::kRows;
using flash::kThreads;
using flash::Params;

// A 1-D grid of B * row_tiles * n_kv blocks: batch row b, then its row
// tiles from the last (heaviest) down, then kv heads; the block body is
// flash_hopper.cuh's.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    causal_parts_kernel(__grid_constant__ const CUtensorMap kmap,
                        __grid_constant__ const CUtensorMap vmap, const Params p,
                        int row_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned per_b = static_cast<unsigned>(row_tiles) * p.n_kv;
  const int b = static_cast<int>(blockIdx.x / per_b);
  const int rest = static_cast<int>(blockIdx.x % per_b);
  const int tile = row_tiles - 1 - rest / p.n_kv;
  const int kv = rest % p.n_kv;

  int len = p.len[b];
  len = len < 0 ? 0 : (len > p.S ? p.S : len);
  const long long rows = static_cast<long long>(p.S) * p.g;  // of one (b, kv)
  const long long row0 = static_cast<long long>(tile) * kRows;
  const long long last = min(row0 + kRows, rows) - 1;
  const int limit = min(len, static_cast<int>(last / p.g) + 1);
  const int n_tiles = (limit + kKeys - 1) / kKeys;
  flash::run_block<HD, true>(&kmap, &vmap, p, smem_raw, kv, b, b * rows + row0,
                             (b + 1) * rows, 0, len, n_tiles, 0);
}

// k or v [B, S, n_kv, hd] as a 4-D map (hd, n_kv, S, B): one box is 64 head
// columns of kKeys keys of one kv head and one batch row, landing with the
// 128-byte swizzle that the wgmma descriptors name.
bool encode_chunk_map(CUtensorMap* map, const void* base, int B, int S, int n_kv,
                      int hd) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(n_kv),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(n_kv) * hd * 2,
                                 static_cast<cuuint64_t>(S) * n_kv * hd * 2};
  const cuuint32_t box[4] = {64, 1, kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* lens, void* o,
           void* m, void* l, int B, int S, int n_kv, int g, float scale,
           cudaStream_t stream) {
  const long long row_tiles = (static_cast<long long>(S) * g + kRows - 1) / kRows;
  const long long blocks = row_tiles * n_kv * B;
  if (blocks > 0x7fffffffLL) return -4;
  CUtensorMap kmap, vmap;
  if (!encode_chunk_map(&kmap, k, B, S, n_kv, HD) ||
      !encode_chunk_map(&vmap, v, B, S, n_kv, HD)) {
    return -2;
  }
  constexpr int smem = flash::smem_bytes<HD>();
  cudaError_t err = allow_smem_once<causal_parts_kernel<HD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(lens),
           static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
           0, B, S, n_kv, g, S, 0, scale};
  causal_parts_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      kmap, vmap, p, static_cast<int>(row_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tiling the host's twin of the block plan (ops/prefix_attention.
// causal_block_plan) must agree with: query rows per block, keys per tile.
extern "C" void k8s_flash_causal_tiling(int* rows, int* keys) {
  *rows = kRows;
  *keys = kKeys;
}

// Returns a cudaError_t code (0 on success); -1 for an unsupported head dim,
// -2 when the tensor maps cannot be encoded, -4 for more blocks than a 1-D
// grid holds.
extern "C" int k8s_flash_causal_parts(const void* q, const void* k, const void* v,
                                      const void* lens, void* o, void* m, void* l,
                                      int B, int S, int n_kv, int g, int hd,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(B) * S * g * n_kv == 0) return 0;
  if (hd == 128) return launch<128>(q, k, v, lens, o, m, l, B, S, n_kv, g, scale, st);
  if (hd == 64) return launch<64>(q, k, v, lens, o, m, l, B, S, n_kv, g, scale, st);
  return -1;
}
