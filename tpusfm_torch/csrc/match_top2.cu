// Streaming top-2 Hamming matcher for Hopper (sm_90a): int8 wgmma product with
// the top-2 reduction fused in registers. Plain C interface.
//
// Replaces the Pallas TPU kernel tpusfm/features/pallas_match.py::
// match_topk2_pallas (kernel body _make_kernel), which does the +-1 product on
// the MXU in int8 and keeps a running (best, second, idx) per query row. For
// every query row of desc1 (P pairs x F1 rows of 256 +-1 int8 values) this
// returns, over the VALID rows of desc2 (P x F2), the smallest and the
// second-smallest Hamming distance and the index of the first minimum. Neither
// a packed copy of the descriptors nor the F1 x F2 matrix is ever written.
//
// Contract, bit for bit with the TPU kernel and the plain PyTorch version
// (tpusfm_torch/features/pallas_match.py::match_topk2_plain):
//   * distances are the exact integers (256 - a.b) / 2, written as float32; an
//     invalid desc2 row counts as distance 1e9;
//   * idx is the FIRST minimum;
//   * "second" excludes only the argmin row, so a tie for the best gives
//     second == best and the ratio test rejects the match;
//   * with no valid row, idx is 0 and both distances are 1e9.
//
// Bound. 2*P*F1*F2*256 int8 operations (2.8e11 at P=21, F=5120: >= 0.142 ms at
// the H100's 1,979 TOPS); the ~55 MB that must move need only 16 us at
// 3.35 TB/s, so the function is bound by operations.
//
// Design.
//   * Product on the tensor cores, operands as they lie. desc1 and desc2 are
//     row-major with the 256-byte contraction innermost (K-major), the one
//     layout int8 wgmma takes for A and B alike, so nothing is transposed or
//     packed. A block of 3 warpgroups owns 128 query rows of one pair for the
//     whole sweep over F2 (the TPU kernel's sequential grid axis is a loop
//     inside the block: Hopper blocks run in no order). The query tile (32 KB)
//     is loaded once; key tiles of 256 rows x 256 B (64 KB) stream through a
//     2-stage ring filled by the producer warpgroup with cp.async, full/empty
//     mbarriers per stage, fence.proxy.async before the tensor cores read.
//     Both live in the 128-byte-swizzle K-major layout that a wgmma descriptor
//     names: a 256 B row is two 128 B halves, each half its own [row][128 B]
//     plane whose 16-byte chunk c of row r sits at chunk c ^ (r & 7).
//   * Each of the two consumer warpgroups multiplies its 64 rows by a key tile
//     with 8 x wgmma.m64n256k32.s32.s8.s8 into 128 accumulator registers.
//   * Top-2 from the fragments, order-free, by packed keys (below). One
//     multiply-add per element forms the key from the accumulator and a column
//     term staged beside the tile (4-deep ring, so a key stage is released as
//     soon as its product is done, before the epilogue), 2.5 min/max per
//     element keep the thread's two smallest keys per row; the quad merges by
//     shuffle once at the end and lane 0 of the quad writes the row.
//   * Filling the card. grid = (F1 / 128, P): 840 equal blocks at the operating
//     point, one per SM at this shared-memory size, i.e. 6.4 waves on 132 SMs,
//     so the seventh runs 36% full (~10% lost).
//
// What the measured time shows (PERF.md, Findings, has the numbers and the
// script): three loads of the same order, overlapped only in part. Alone, the
// product takes ~0.17 ms at the operating point, the epilogue (~3.75 integer
// instructions per element on ALUs of 64 lanes per SM) ~0.12 ms, and pulling
// each pair's desc2 through L2 once per block (1.1 GB in all, ~6 TB/s) ~0.18 ms;
// any two together take ~0.25 ms, all three ~0.29 ms. The two warpgroups run
// their products together and their epilogues together: one warpgroup alone
// keeps the tensor cores at ~80% of what two reach, and an epilogue that runs
// under the other group's product slows that product down, so handing the
// tensor cores from one group to the other (a pair of mbarriers, signalled
// once the product is queued or once it is complete) gained nothing and was
// taken out. Also tried and slower: TMA loads (alone, and multicast to
// clusters of 2 and 4 blocks, which cuts the L2 traffic but couples the
// blocks), key tiles of 128 rows with two accumulators in flight per
// warpgroup, A fragments from registers (spills), and persistent blocks with
// a double-buffered query tile (the ~10% that a block's prologue costs came
// back as slower loads).
//
// Resources: 384 threads, 168 registers at launch (ptxas; 0 spills); setmaxnreg
// raises the 2 consumer warpgroups to 232 and lowers the producer warpgroup to
// 40. 168,000 B of dynamic shared memory + 1 KB of alignment slack.
//
// ABLATE_LOAD, ABLATE_PRODUCT and ABLATE_EPILOGUE (compile-time) each leave one
// of the three out, for tools/bench_match.py --ablate; the outputs are then
// wrong by design.
#include <cstdint>
#include <cuda_runtime.h>

// ---- The packed-key top-2 reduction.
//
// The int8 product of two +-1 rows of 256 values is dot in [-256, 256], even,
// and the Hamming distance is d = (256 - dot) / 2 in [0, 256]. One 32-bit key
// per (query row, key row j) carries both:
//
//     key = (d << 22) | j  =  ((256 - dot) << 21) + j      (j < 2^22)
//
// so a key is one multiply-add from the accumulator plus a per-column term
// ((256 << 21) + j) that the block stages beside each key tile. An INVALID key
// row gets the term (770 << 21) + j instead: whatever its dot, its key is then
// at least 514 << 21, above every valid key, and unpacks to "no match" (1e9).
// Keys are unique per row, so the smallest key is the smallest distance at its
// FIRST index whatever the order in which the columns were visited, and the two
// smallest keys give best, idx and second (which excludes only the argmin: a
// tie for best gives second == best). The tensor-core fragment layouts deal a
// row's columns to the four threads of a quad; each keeps its own two smallest
// keys and the quad merges once at the end (the top-2 of a union is the merge
// of the top-2s). tests/test_torch_match_keys.py holds this algebra, emulated
// in PyTorch, against the plain version and the TPU kernel.
namespace top2 {

constexpr uint32_t kDotScale = 0xFFE00000u;     // -(1 << 21) modulo 2^32
constexpr uint32_t kValidTerm = 256u << 21;
constexpr uint32_t kInvalidTerm = 770u << 21;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;        // unpacks as invalid
constexpr int kIndexBits = 22;

__device__ __forceinline__ uint32_t column_term(bool valid, int j) {
  return (valid ? kValidTerm : kInvalidTerm) + static_cast<uint32_t>(j);
}

__device__ __forceinline__ uint32_t make_key(int dot, uint32_t term) {
  return term + static_cast<uint32_t>(dot) * kDotScale;
}

// (b, s) <- two smallest of {b, s, k0, k1}, given b <= s: five min/max for two
// elements (with the three-input minimum that sm_90 has).
__device__ __forceinline__ void push2(uint32_t& b, uint32_t& s, uint32_t k0, uint32_t k1) {
  const uint32_t lo = min(k0, k1);
  const uint32_t hi = max(k0, k1);
  s = min(s, min(max(b, lo), hi));
  b = min(b, lo);
}

__device__ __forceinline__ void merge(uint32_t& b, uint32_t& s, uint32_t b2, uint32_t s2) {
  s = min(max(b, b2), min(s, s2));
  b = min(b, b2);
}

// The four lanes of a quad (lane ^ 1, lane ^ 2) hold the same row.
__device__ __forceinline__ void quad_merge(uint32_t& b, uint32_t& s) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const uint32_t b2 = __shfl_xor_sync(0xffffffffu, b, off);
    const uint32_t s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(b, s, b2, s2);
  }
}

__device__ __forceinline__ void write_row(uint32_t b, uint32_t s, float* __restrict__ best,
                                          float* __restrict__ second, int32_t* __restrict__ idx,
                                          long long row) {
  const uint32_t db = b >> kIndexBits;
  const uint32_t ds = s >> kIndexBits;
  best[row] = db > 256u ? 1e9f : static_cast<float>(db);
  second[row] = ds > 256u ? 1e9f : static_cast<float>(ds);
  idx[row] = db > 256u ? 0 : static_cast<int32_t>(b & ((1u << kIndexBits) - 1u));
}

__device__ __forceinline__ void cp_async16(uint32_t dst_shared, const void* src_global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst_shared),
               "l"(__cvta_generic_to_global(src_global))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace top2

namespace {

constexpr int kRowBytes = 256;
constexpr int kQueryTile = 128;                 // query rows per block: 64 per consumer warpgroup
constexpr int kKeyTile = 256;                   // key rows per stage = N of one wgmma
constexpr int kKeyStages = 2;
constexpr int kTermStages = 4;
constexpr int kThreads = 384;
constexpr int kProducerThreads = 128;
constexpr int kPlane = 128;                     // bytes of a row in one swizzled plane
constexpr int kQueryPlane = kQueryTile * kPlane;          // 16 KB
constexpr int kKeyPlane = kKeyTile * kPlane;              // 32 KB
constexpr int kKeyStageBytes = 2 * kKeyPlane;             // 64 KB
constexpr int kQueryOff = 0;
constexpr int kKeysOff = kQueryOff + 2 * kQueryPlane;
constexpr int kTermsOff = kKeysOff + kKeyStages * kKeyStageBytes;
constexpr int kBarOff = kTermsOff + kTermStages * kKeyTile * 4;
// barriers: key_full[2], key_empty[2], term_free[4]
constexpr int kBarKeyFull = 0, kBarKeyEmpty = 2, kBarTermFree = 4, kNumBars = 8;
constexpr int kSmemUsed = kBarOff + kNumBars * 8;
constexpr int kSmemBytes = kSmemUsed + 1024;    // the planes need 1024-byte alignment

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed (a fresh barrier has
// "completed" the phase of parity 1). No wait of this kernel lasts longer than
// a key tile's load or product (microseconds): one that outlasts kStuckClocks
// is a deadlock, and traps so that the launch fails instead of hanging.
constexpr long long kStuckClocks = 4000000000LL;

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kStuckClocks) __trap();
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: start address,
// 1024 B between groups of 8 rows (the leading offset is not used in this mode).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// k-step ks of 8: plane ks / 4, 32 bytes further along the 128-byte row per step.
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int ks, int plane_bytes) {
  return desc + static_cast<uint64_t>(((ks >> 2) * plane_bytes + (ks & 3) * 32) >> 4);
}

// D (64 x 256, s32) = A (64 x 32, s8, K-major) . B (256 x 32, s8, K-major)^T (+ D)
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The compiler does not know that wgmma writes the accumulator asynchronously:
// pin every register so that no use moves across the wgmma or the wait.
__device__ __forceinline__ void fence_accumulator(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 16-byte chunk c (of 16) of row r -> its place in the two swizzled planes.
__device__ __forceinline__ uint32_t swizzled(int r, int c, int plane_bytes) {
  return (c >> 3) * plane_bytes + r * kPlane + (((c & 7) ^ (r & 7)) << 4);
}

__global__ void __launch_bounds__(kThreads, 1)
match_top2_wgmma(const int8_t* __restrict__ desc1, const int8_t* __restrict__ desc2,
                 const uint8_t* __restrict__ valid2, float* __restrict__ best_out,
                 float* __restrict__ second_out, int32_t* __restrict__ idx_out, int F1, int F2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t smem_addr = raw_addr + pad;
  const uint32_t bars = smem_addr + kBarOff;
  auto bar = [&](int which, int i) { return bars + 8u * (which + i); };

  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const long long row_base = static_cast<long long>(p) * F1 + blockIdx.x * kQueryTile;
  const int n_tiles = F2 / kKeyTile;

  if (tid == 0) {
    for (int i = 0; i < kKeyStages; ++i) {
      mbar_init(bar(kBarKeyFull, i), kProducerThreads);
      mbar_init(bar(kBarKeyEmpty, i), 8);       // one arrival per consumer warp
    }
    for (int i = 0; i < kTermStages; ++i) mbar_init(bar(kBarTermFree, i), 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query tile, by every thread
  {
    const int8_t* src = desc1 + row_base * kRowBytes;
    for (int id = tid; id < kQueryTile * 16; id += kThreads)
      top2::cp_async16(smem_addr + kQueryOff + swizzled(id >> 4, id & 15, kQueryPlane), src + id * 16);
    top2::cp_async_commit();
    top2::cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kThreads - kProducerThreads) {
    // ---------------- producer warpgroup: fills the key and term rings
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = tid - (kThreads - kProducerThreads);
    const int8_t* keys = desc2 + static_cast<long long>(p) * F2 * kRowBytes;
    const uint8_t* valid = valid2 + static_cast<long long>(p) * F2;
    for (int t = 0; t < n_tiles; ++t) {
      const int ks = t % kKeyStages, ts = t % kTermStages;
      mbar_wait(bar(kBarKeyEmpty, ks), ((t / kKeyStages) & 1) ^ 1);
      mbar_wait(bar(kBarTermFree, ts), ((t / kTermStages) & 1) ^ 1);
      const uint32_t stage = smem_addr + kKeysOff + ks * kKeyStageBytes;
      const int8_t* src = keys + static_cast<long long>(t) * kKeyTile * kRowBytes;
#ifndef ABLATE_LOAD
#pragma unroll 8
      for (int it = 0; it < kKeyTile * 16 / kProducerThreads; ++it) {
        const int id = it * kProducerThreads + ptid;
        top2::cp_async16(stage + swizzled(id >> 4, id & 15, kKeyPlane), src + id * 16);
      }
#endif
      top2::cp_async_commit();
      uint32_t* terms = reinterpret_cast<uint32_t*>(smem + kTermsOff) + ts * kKeyTile;
#pragma unroll
      for (int c = ptid; c < kKeyTile; c += kProducerThreads) {
        const int j = t * kKeyTile + c;
        terms[c] = top2::column_term(valid[j] != 0, j);
      }
      top2::cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar(kBarKeyFull, ks));
    }
  } else {
    // ---------------- consumer warpgroups: product, then the top-2 of its fragments
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const uint64_t desc_q = smem_desc(smem_addr + kQueryOff + wg * 64 * kPlane);
    int acc[128];
    // this thread's rows: r0 = 16 * (warp in group) + g and r0 + 8 of the group's 64
    uint32_t b0 = top2::kNoKey, s0 = top2::kNoKey, b1 = top2::kNoKey, s1 = top2::kNoKey;

    for (int t = 0; t < n_tiles; ++t) {
      const int ks = t % kKeyStages, ts = t % kTermStages;
      mbar_wait(bar(kBarKeyFull, ks), (t / kKeyStages) & 1);
      const uint64_t desc_k = smem_desc(smem_addr + kKeysOff + ks * kKeyStageBytes);
      fence_accumulator(acc);
#ifndef ABLATE_PRODUCT
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < 8; ++k)
        wgmma_m64n256k32_s8(acc, k_step(desc_q, k, kQueryPlane), k_step(desc_k, k, kKeyPlane), k != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_accumulator(acc);
#endif
      if (lane == 0) mbar_arrive(bar(kBarKeyEmpty, ks));
      __syncwarp();

      // fragment: acc[4i], acc[4i+1] = row r0, columns 8i + 2*tig, +1; acc[4i+2], acc[4i+3] = row r0+8
      const uint2* terms = reinterpret_cast<const uint2*>(smem + kTermsOff) + ts * (kKeyTile / 2) + tig;
#ifdef ABLATE_EPILOGUE
      b0 = min(b0, top2::make_key(acc[0] ^ acc[127], terms[0].x));
#else
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint2 ct = terms[4 * i];
        top2::push2(b0, s0, top2::make_key(acc[4 * i], ct.x), top2::make_key(acc[4 * i + 1], ct.y));
        top2::push2(b1, s1, top2::make_key(acc[4 * i + 2], ct.x), top2::make_key(acc[4 * i + 3], ct.y));
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kBarTermFree, ts));
      __syncwarp();
    }

    top2::quad_merge(b0, s0);
    top2::quad_merge(b1, s1);
    if (tig == 0) {
      const long long row = row_base + wg * 64 + ((tid >> 5) & 3) * 16 + g;
      top2::write_row(b0, s0, best_out, second_out, idx_out, row);
      top2::write_row(b1, s1, best_out, second_out, idx_out, row + 8);
    }
  }
}

}  // namespace

// desc1 (P, F1, 256) int8, desc2 (P, F2, 256) int8, valid2 (P, F2) bool (1 byte);
// outputs best and second float32 (P, F1), idx int32 (P, F1). All contiguous on
// one device, F1 a multiple of 128, F2 of 256, F2 < 2^22. Launches on `stream`
// and returns the CUDA error of the launch (0 on success).
extern "C" int tpusfm_match_top2(const void* desc1, const void* desc2, const void* valid2,
                                 void* best, void* second, void* idx, int P, int F1, int F2, int D,
                                 void* stream) {
  if (D != kRowBytes || P <= 0 || F1 <= 0 || F2 <= 0 || F1 % kQueryTile != 0 ||
      F2 % kKeyTile != 0 || F2 >= (1 << top2::kIndexBits))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(match_top2_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(F1 / kQueryTile, P);
  match_top2_wgmma<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(desc1), static_cast<const int8_t*>(desc2),
      static_cast<const uint8_t*>(valid2), static_cast<float*>(best), static_cast<float*>(second),
      static_cast<int32_t*>(idx), F1, F2);
  return static_cast<int>(cudaGetLastError());
}
