// K3: candidate-support counting over dense {0,1} operands on the tensor
// cores, for sm_90a.
//
// Replaces src/repro/kernels/support_count.py::support_count_pallas (the
// Pallas kernel `_kernel`, pallas_call at :101).  Computes, exactly,
//
//   counts[k] = sum_{n < N} [ <t_n, c_k> == len[k] ]
//
// a {0,1} matrix product with the containment test and the sum over N fused
// into its epilogue, so the (N, K) intersection matrix never leaves
// registers.  Two operand types, one template: bf16 with f32 accumulation
// (exact: every partial sum is an integer below 2^24) and int8 with s32.
//
// What bounds it on this card: operations.  At the dense mine's level-2 pass
// (N = 100,000 rows, 41,616 real candidates padded to Kp = 65,536, 1,000
// items padded to Ip = 1,024) the counts need 2*N*41,616*1,000 = 8.3e12
// operations over about 0.3 GB of operands: 8.4 ms at the dense 989 TFLOP/s
// bf16 rate, 4.2 ms at 1,979 TOP/s int8, against 0.1 ms for the bytes.  So
// the design spends everything on keeping the tensor cores fed:
//   * wgmma, the only instruction that reaches Hopper's full rate:
//     m64n256k16 f32.bf16.bf16 and m64n256k32 s32.s8.s8.  Both read 32 bytes
//     of items per instruction, so staging, descriptors and pipeline are
//     byte for byte the same for the two types; only the instruction and the
//     accumulator type differ.
//   * Candidates on M, transactions on N: a tile is 128 candidates (two
//     consumer warpgroups of m64) x 256 transactions.  A thread's 128
//     accumulators then hold 2 candidates x 64 transactions, so its count
//     needs 2 counters (not one per column) and nothing spills.
//   * TMA: both operands are row-major, i.e. K-major, the only layout wgmma
//     takes for 8-bit types, so nothing is transposed.  One 2-D tensor map
//     per operand, encoded on the host at each launch (the operands move
//     every pass) and passed as __grid_constant__; a box is 128 bytes of
//     items x the tile's rows with 128-byte swizzle, which the wgmma
//     descriptors (SBO 1,024 bytes, +32 bytes per k-step) read without bank
//     conflicts.  TMA's zero fill covers the N and K edges and an Ip that is
//     not a multiple of the box.  cuTensorMapEncodeTiled comes through the
//     runtime's driver entry point, so the library needs no -lcuda.
//   * A ring of 4 stages of 48 KB (16 KB candidates + 32 KB transactions)
//     with full and empty mbarriers.  Warp-specialised: one thread of the
//     producer warpgroup (setmaxnreg 40) starts the TMA loads; the two
//     consumer warpgroups (setmaxnreg 232) keep one wgmma group in flight
//     and free each stage as soon as its products are done, so the loads of
//     the next tile overlap each tile's epilogue.
//   * Persistent: one block per SM.  Each block first lists the live
//     candidate tiles (any len >= 0) in order, so a tile that is all padding
//     costs one read of its lengths, wherever it lies in K.  Work units
//     (live tile, 256-row tile) go round the blocks in a grouped raster of
//     16 tiles: blocks running at once share a few tiles of each operand in
//     L2.
//   * The epilogue stays in registers: the wgmma accumulator layout is
//     documented (lane l of warp w holds rows 16w + l/4 and +8 at columns
//     8j + 2(l%4) + {0,1}), so each thread compares its own accumulators
//     with its two candidates' len, masks transactions past N (a zero-filled
//     row would match a len = 0 candidate), sums over its quad (xor 1, 2)
//     and adds the sum with one int32 atomicAdd per candidate and unit.  No
//     fragment goes through shared memory; integer atomics commute, so the
//     counts are exact and the same in any order.
// Rows with len = -1 never match (an intersection is >= 0); zero rows and
// zero item columns add nothing; len = 0 counts N.  A launch covers at most
// 65,536 candidates (512 tiles, the block's list); the host launches one grid
// per such window.  The kernel allocates nothing and launches on the caller's
// stream.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBM = 128;          // candidates per tile: two consumer warpgroups x m64
constexpr int kBN = 256;          // transaction rows per tile: wgmma n256
constexpr int kSlabBytes = 128;   // item bytes per staged slab: one 128-byte swizzle row
constexpr int kKSteps = 4;        // wgmma k-steps of 32 bytes per slab
constexpr int kStages = 4;
constexpr int kCTileBytes = kBM * kSlabBytes;   // 16 KB
constexpr int kTTileBytes = kBN * kSlabBytes;   // 32 KB
constexpr int kStageBytes = kCTileBytes + kTTileBytes;
constexpr int kMaxTiles = 512;    // candidate tiles per launch (65,536 candidates)
constexpr int kGroup = 16;        // live candidate tiles per raster group
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;     // two consumer warpgroups, then the producer warpgroup

struct Shared {                   // after the stages
  uint64_t full[kStages];
  uint64_t empty[kStages];
  int nlive;
  uint16_t live[kMaxTiles];
  uint8_t flag[kMaxTiles];
};

constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + sizeof(Shared);

#define K3_ACC_REGS                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "     \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "     \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"
#define K3_ACC8(C, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define K3_ACC128(C)                                                                              \
  K3_ACC8(C, 0), K3_ACC8(C, 8), K3_ACC8(C, 16), K3_ACC8(C, 24), K3_ACC8(C, 32), K3_ACC8(C, 40),   \
  K3_ACC8(C, 48), K3_ACC8(C, 56), K3_ACC8(C, 64), K3_ACC8(C, 72), K3_ACC8(C, 80), K3_ACC8(C, 88), \
  K3_ACC8(C, 96), K3_ACC8(C, 104), K3_ACC8(C, 112), K3_ACC8(C, 120)

// d (64 candidates x 256 transactions) += A (64 x 32 bytes of items) . B (256 x 32 bytes)^T,
// both K-major in shared memory; scale_d = 0 overwrites d.
struct Bf16 {
  using Acc = float;
  static constexpr int kElemBytes = 2;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " K3_ACC_REGS ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : K3_ACC128("+f")
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
struct S8 {
  using Acc = int;
  static constexpr int kElemBytes = 1;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ static __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " K3_ACC_REGS ", %128, %129, p;\n}\n"
        : K3_ACC128("+r")
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// One box (128 bytes of items x the map's box rows) at (item x, row y) into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// wgmma descriptor of a K-major tile staged by TMA with 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1,024 bytes apart (SBO), tile 1,024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }
template <typename A>
__device__ __forceinline__ void fence_acc(A (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) reg_fence(d[i]);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The slab's four k-steps: A is this warpgroup's 64 candidate rows of the
// stage, B the stage's 256 transaction rows; 32 bytes of items per step.
template <typename Ty>
__device__ __forceinline__ void mma_slab(typename Ty::Acc (&d)[128], const uint8_t* stage, int wg, bool first) {
  const uint64_t da = smem_desc(stage + wg * 64 * kSlabBytes);
  const uint64_t db = smem_desc(stage + kCTileBytes);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) Ty::mma(d, da + 2 * ks, db + 2 * ks, (first && ks == 0) ? 0 : 1);
}

// Hits of one tile in this thread's accumulators: d[4j + 2h + v] is candidate
// row lane/4 + 16*warp + 8h against transaction 8j + 2*(lane%4) + v of the
// tile; transactions at or past rows_left (zero-filled by TMA) are masked.
template <typename A>
__device__ __forceinline__ void count_hits(const A (&d)[128], A len0, A len1, int rows_left, int q,
                                           int& h0, int& h1) {
  if (rows_left >= kBN) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      h0 += (d[4 * j] == len0) + (d[4 * j + 1] == len0);
      h1 += (d[4 * j + 2] == len1) + (d[4 * j + 3] == len1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * q;
      const bool in0 = col < rows_left, in1 = col + 1 < rows_left;
      h0 += (in0 && d[4 * j] == len0) + (in1 && d[4 * j + 1] == len0);
      h1 += (in0 && d[4 * j + 2] == len1) + (in1 && d[4 * j + 3] == len1);
    }
  }
}

// The four lanes of a quad hold the same two candidates: sum, then one
// atomicAdd per candidate that has hits.
__device__ __forceinline__ void flush_hits(int32_t* out, int cand, int h0, int h1, int q) {
  h0 += __shfl_xor_sync(0xFFFFFFFFu, h0, 1);
  h0 += __shfl_xor_sync(0xFFFFFFFFu, h0, 2);
  h1 += __shfl_xor_sync(0xFFFFFFFFu, h1, 1);
  h1 += __shfl_xor_sync(0xFFFFFFFFu, h1, 2);
  if (q == 0) {
    if (h0) atomicAdd(out + cand, h0);
    if (h1) atomicAdd(out + cand + 8, h1);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Unit u of the grouped raster: kGroup live candidate tiles side by side,
// walked one transaction tile at a time, so the blocks running at once share
// a few candidate tiles and a few transaction tiles in L2.
__device__ __forceinline__ void unit_coords(int u, int nlive, int nrt, int& j, int& rt) {
  const int per_group = kGroup * nrt;
  const int g = u / per_group;
  const int first = g * kGroup;
  const int gsize = min(kGroup, nlive - first);
  const int w = u - g * per_group;
  j = first + w % gsize;
  rt = w / gsize;
}

template <typename Ty>
__global__ void __launch_bounds__(kThreads, 1)
support_count_kernel(const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_t,
                     const int32_t* __restrict__ lengths, int32_t* __restrict__ out, int n, int k,
                     int nslabs) {
  using Acc = typename Ty::Acc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  Shared& sh = *reinterpret_cast<Shared*>(stages + kStages * kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The live candidate tiles (any len >= 0), in order.
  const int ntiles = (k + kBM - 1) / kBM;
  for (int t = tid; t < ntiles; t += kThreads) sh.flag[t] = 0;
  __syncthreads();
#pragma unroll 4
  for (int i = 4 * tid; i < k; i += 4 * kThreads) {
    bool live = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) live |= i + e < k && __ldg(lengths + i + e) >= 0;
    if (live) sh.flag[i / kBM] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const bool f = t0 + lane < ntiles && sh.flag[t0 + lane];
      const unsigned b = __ballot_sync(0xFFFFFFFFu, f);
      if (f) sh.live[count + __popc(b & ((1u << lane) - 1u))] = static_cast<uint16_t>(t0 + lane);
      count += __popc(b);
    }
    if (lane == 0) sh.nlive = count;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nlive = sh.nlive, nrt = (n + kBN - 1) / kBN;
  const int units = nlive * nrt;
  if (static_cast<int>(blockIdx.x) >= units) return;

  if (warp >= kConsumerWarps) {
    // Producer: one thread keeps the ring full with TMA loads.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int j, rt;
        unit_coords(u, nlive, nrt, j, rt);
        const int c_row = sh.live[j] * kBM, t_row = rt * kBN;
        for (int s = 0; s < nslabs; ++s) {
          mbar_wait(&sh.empty[stage], phase ^ 1u);
          mbar_expect_tx(&sh.full[stage], kStageBytes);
          uint8_t* dst = stages + stage * kStageBytes;
          const int x = s * (kSlabBytes / Ty::kElemBytes);
          tma_load(dst, &map_c, &sh.full[stage], x, c_row);
          tma_load(dst + kCTileBytes, &map_t, &sh.full[stage], x, t_row);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg multiplies candidate rows [64 wg, 64 wg + 64) of
    // each tile against its 256 transactions, one wgmma group in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, q = lane & 3;
    const int row_in_tile = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    Acc d[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int j, rt;
      unit_coords(u, nlive, nrt, j, rt);
      const int cand = sh.live[j] * kBM + row_in_tile;
      const Acc len0 = static_cast<Acc>(cand < k ? __ldg(lengths + cand) : -1);
      const Acc len1 = static_cast<Acc>(cand + 8 < k ? __ldg(lengths + cand + 8) : -1);
      int prev = 0;
      for (int s = 0; s < nslabs; ++s) {
        mbar_wait(&sh.full[stage], phase);
        fence_acc(d);
        wgmma_fence();
        mma_slab<Ty>(d, stages + stage * kStageBytes, wg, s == 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done
        fence_acc(d);
        if (s > 0 && lane == 0) mbar_arrive(&sh.empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&sh.empty[prev]);
      int h0 = 0, h1 = 0;
      count_hits(d, len0, len1, n - rt * kBN, q, h0, h1);
      flush_hits(out, cand, h0, h1, q);
    }
  }
}

// ------------------------------------------------------------------ host ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
EncodeTiled load_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// A row-major (rows, ip) operand as boxes of 128 bytes of items x box_rows
// rows, 128-byte swizzled; reads past either edge fill zeros.
template <typename Ty>
bool encode(CUtensorMap* map, const void* base, int rows, int ip, int box_rows) {
  static const EncodeTiled fn = load_encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ip), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ip) * Ty::kElemBytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlabBytes / Ty::kElemBytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, Ty::kTmaType, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Ty>
cudaError_t launch_typed(const void* t, const void* c, const int32_t* len, int32_t* out, int n, int k, int ip,
                         int sms, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(support_count_kernel<Ty>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int nslabs = (ip * Ty::kElemBytes + kSlabBytes - 1) / kSlabBytes;
  const long long nrt = (n + kBN - 1) / kBN;
  CUtensorMap map_t;
  if (!encode<Ty>(&map_t, t, n, ip, kBN)) return cudaErrorInvalidValue;
  for (int k0 = 0; k0 < k; k0 += kMaxTiles * kBM) {
    const int kw = min(kMaxTiles * kBM, k - k0);
    if ((kw + kBM - 1) / kBM * nrt > 0x7FFFFFFF) return cudaErrorInvalidValue;
    CUtensorMap map_c;
    if (!encode<Ty>(&map_c, static_cast<const char*>(c) + static_cast<size_t>(k0) * ip * Ty::kElemBytes, kw, ip,
                    kBM))
      return cudaErrorInvalidValue;
    const int grid = static_cast<int>(std::min<long long>(sms, (kw + kBM - 1) / kBM * nrt));
    support_count_kernel<Ty><<<grid, kThreads, kSmemBytes, stream>>>(map_c, map_t, len + k0, out + k0, n, kw,
                                                                      nslabs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// t (n, ip), c (k, ip) {0,1} operands, row-major, 16-byte aligned, with ip a
// multiple of 16; dtype 0 = bf16, 1 = int8.  lengths (k,) int32; out (k,)
// int32, zeroed by the caller.  sms: the card's SM count (the persistent
// grid).  Returns the first CUDA error of the launch, or 0.
extern "C" int support_count_launch(const void* t, const void* c, const void* lengths, void* out, int n, int k,
                                    int ip, int dtype, int sms, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (ip <= 0 || ip % 16 != 0 || sms <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(t) & 15) || (reinterpret_cast<uintptr_t>(c) & 15))
    return (int)cudaErrorMisalignedAddress;
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_typed<Bf16>(t, c, lp, op, n, k, ip, sms, s)
                          : launch_typed<S8>(t, c, lp, op, n, k, ip, sms, s));
}
