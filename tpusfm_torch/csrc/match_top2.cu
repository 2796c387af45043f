// Streaming top-2 Hamming matcher for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tpusfm/features/pallas_match.py::
// match_topk2_pallas (kernel body _make_kernel). For every query row of
// desc1 (P pairs x F1 rows of 256 +-1 values) it returns, over the VALID
// rows of desc2 (P x F2), the smallest and second-smallest Hamming
// distance and the index of the first minimum. desc2 streams through
// shared memory; the F1 x F2 distance matrix is never written.
//
// Contract kept bit for bit with the TPU kernel and the plain PyTorch
// version (tpusfm_torch/features/pallas_match.py::match_topk2_plain):
//   * distances are exact integers, written as float32; an invalid desc2
//     row counts as distance 1e9;
//   * the index is the FIRST minimum: j runs in ascending order and the
//     running update uses a strict "<";
//   * "second" excludes only the argmin row, so a tie for the best gives
//     second == best and the ratio test rejects the match;
//   * with no valid row, idx stays 0 and both distances stay 1e9.
//
// Design. A pack kernel turns the +-1 int8 descriptors into 256 bits
// (8 x uint32 per row; bit set iff value > 0) with one warp ballot per
// 32 values. The match kernel runs one block per (128-row query tile,
// pair): each thread holds its query row's 8 words in registers, the
// block stages desc2 tiles of 256 rows x 32 B (+ validity) in shared
// memory, and each thread walks the tile with d = sum popc(q ^ k) and a
// running (best, second, idx). The TPU kernel's sequential-grid
// accumulator (pl.when(j == 0) + output blocks resident across grid
// steps) becomes this loop inside the block: Hopper blocks run in no
// order, so nothing may carry over between them.
//
// Bound. As int8 tensor-core work the same function is 2*P*F1*F2*256
// operations (2.8e11 at P=21, F=5120: >= 0.14 ms at 1,979 TOPS); the
// bytes it must move (int8 inputs once, outputs once) are ~55 MB, >= 16 us
// at 3.35 TB/s, so it is compute-bound. This kernel does the work on the
// integer ALUs instead (8 POPC per row pair, 16 POPC/clk/SM), which puts
// it near 1 ms at the operating point — a simple kernel that is right
// first; wgmma/TMA tiling is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 256;
constexpr int kWords = kBits / 32;      // 8 x uint32 per packed row
constexpr int kQueryTile = 128;         // query rows per block (one per thread)
constexpr int kKeyTile = 256;           // desc2 rows per shared-memory tile
constexpr int kInvalid = 1 << 20;       // distance of an invalid row (> any Hamming distance)
constexpr int kPackThreads = 256;

__global__ void pack_signs(const int8_t* __restrict__ src, uint32_t* __restrict__ dst,
                           long long n_values) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // n_values is a multiple of 32 and blockDim of 32: whole warps leave together
  if (i >= n_values) return;
  const unsigned bits = __ballot_sync(0xffffffffu, src[i] > 0);
  if ((threadIdx.x & 31) == 0) dst[i >> 5] = bits;
}

__global__ void __launch_bounds__(kQueryTile)
match_top2(const uint32_t* __restrict__ bits1, const uint32_t* __restrict__ bits2,
           const uint8_t* __restrict__ valid2, float* __restrict__ best_out,
           float* __restrict__ second_out, int32_t* __restrict__ idx_out, int F1, int F2) {
  __shared__ uint4 tile[kKeyTile][2];     // 256 rows x 32 B
  __shared__ int tile_valid[kKeyTile];

  const int p = blockIdx.y;
  const long long row = static_cast<long long>(p) * F1 + blockIdx.x * kQueryTile + threadIdx.x;
  const uint4* q = reinterpret_cast<const uint4*>(bits1 + row * kWords);
  const uint4 qa = q[0];
  const uint4 qb = q[1];
  const uint4* keys = reinterpret_cast<const uint4*>(bits2 + static_cast<long long>(p) * F2 * kWords);
  const uint8_t* valid = valid2 + static_cast<long long>(p) * F2;

  int best = kInvalid;
  int second = kInvalid;
  int arg = 0;
  for (int j0 = 0; j0 < F2; j0 += kKeyTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * kKeyTile; t += kQueryTile)
      tile[t >> 1][t & 1] = keys[2LL * j0 + t];
    for (int t = threadIdx.x; t < kKeyTile; t += kQueryTile)
      tile_valid[t] = valid[j0 + t];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeyTile; ++j) {
      const uint4 ka = tile[j][0];
      const uint4 kb = tile[j][1];
      int d = __popc(qa.x ^ ka.x) + __popc(qa.y ^ ka.y) + __popc(qa.z ^ ka.z) +
              __popc(qa.w ^ ka.w) + __popc(qb.x ^ kb.x) + __popc(qb.y ^ kb.y) +
              __popc(qb.z ^ kb.z) + __popc(qb.w ^ kb.w);
      d = tile_valid[j] ? d : kInvalid;
      if (d < best) {
        second = best;
        best = d;
        arg = j0 + j;
      } else if (d < second) {
        second = d;
      }
    }
  }
  best_out[row] = best == kInvalid ? 1e9f : static_cast<float>(best);
  second_out[row] = second == kInvalid ? 1e9f : static_cast<float>(second);
  idx_out[row] = arg;
}

}  // namespace

// desc1 (P, F1, 256) int8, desc2 (P, F2, 256) int8, valid2 (P, F2) bool
// (1 byte); bits1/bits2 are scratch of P*F*8 uint32 each; outputs best and
// second float32 (P, F1), idx int32 (P, F1). All contiguous on one device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpusfm_match_top2(const void* desc1, const void* desc2, const void* valid2,
                                 void* bits1, void* bits2, void* best, void* second, void* idx,
                                 int P, int F1, int F2, int D, void* stream) {
  if (D != kBits || P <= 0 || F1 <= 0 || F2 <= 0 || F1 % kQueryTile != 0 || F2 % kKeyTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n1 = static_cast<long long>(P) * F1 * kBits;
  const long long n2 = static_cast<long long>(P) * F2 * kBits;
  pack_signs<<<static_cast<unsigned>((n1 + kPackThreads - 1) / kPackThreads), kPackThreads, 0, s>>>(
      static_cast<const int8_t*>(desc1), static_cast<uint32_t*>(bits1), n1);
  pack_signs<<<static_cast<unsigned>((n2 + kPackThreads - 1) / kPackThreads), kPackThreads, 0, s>>>(
      static_cast<const int8_t*>(desc2), static_cast<uint32_t*>(bits2), n2);
  const dim3 grid(F1 / kQueryTile, P);
  match_top2<<<grid, kQueryTile, 0, s>>>(
      static_cast<const uint32_t*>(bits1), static_cast<const uint32_t*>(bits2),
      static_cast<const uint8_t*>(valid2), static_cast<float*>(best),
      static_cast<float*>(second), static_cast<int32_t*>(idx), F1, F2);
  return static_cast<int>(cudaGetLastError());
}
