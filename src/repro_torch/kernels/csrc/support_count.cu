// K3: candidate-support counting over dense {0,1} operands on the tensor
// cores, for sm_90a.
//
// Replaces src/repro/kernels/support_count.py::support_count_pallas (the
// Pallas kernel `_kernel`).  Computes, exactly,
//
//   counts[k] = sum_n [ <t_n, c_k> == len[k] ]
//
// a {0,1} matrix product T (N x I) . C^T (I x K) with the containment test
// and the column sum fused into its epilogue, so the (N, K) intersection
// matrix never reaches device memory.  Two operand types, one template:
//   * bf16 operands, float accumulators (wmma bf16 m16n16k16): exact, since
//     every product is 0 or 1 and every partial sum an integer below 2^24;
//   * int8 operands, int accumulators (wmma s8 m16n16k16).
//
// What bounds it on this card: operations.  At the main path's level-2 pass
// (N = 100,000 rows, 41,616 candidates padded to Kp = 65,536, I = 1,000
// items padded to Ip = 1,024) the counts need 2*N*41,616*I = 8.3e12
// operations over about 0.3 GB of bf16 operands: 8.4 ms at the dense
// 989 TFLOP/s bf16 rate (4.2 ms at 1,979 int8 TOP/s) against 0.1 ms for the
// bytes.  The design is the simple tensor-core GEMM that is right; it
// spends nothing on the rest:
//   * a block whose 128 candidates are all padding (len = -1) returns at
//     once: their counts stay 0;
//   * grid = (candidate tiles of 128, transaction splits); a block of 8
//     warps owns a 128-row x 128-candidate output tile and walks every
//     128-row tile of its split, so one block issues one int32 atomicAdd per
//     candidate for its whole split (not one per row tile);
//   * the item axis is staged in slabs of 64 through shared memory with
//     16-byte cp.async copies, double-buffered, zero-filling rows past the
//     split, candidates past K and items past Ip;
//   * each warp computes a 32 x 64 sub-tile (2 x 4 wmma fragments) per
//     16-item step; slabs are laid out [step][row][ldm] so every fragment
//     pointer is 32-byte aligned (ldm 24 for bf16 also keeps ldmatrix free
//     of bank conflicts; int8 needs ldm 16);
//   * epilogue per row tile: each fragment goes through a per-warp 16 x 16
//     scratch in shared memory (fragment layouts are opaque), each lane
//     compares one column's values with len (as a float for bf16, exactly;
//     as an int for int8) over 8 rows, masking rows past N, and the two
//     half-warps add; the hits stay in registers until the block ends, then
//     shared atomics combine the 4 row warps and one global atomicAdd per
//     candidate publishes.  Integer atomics commute: the counts are exact
//     and the same in any order.
// Rows with len = -1 never match (an intersection is >= 0); zero rows, zero
// item columns and zero candidate rows add nothing.  wgmma, TMA and a
// persistent warp-specialised design are later work.  The kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBN = 128;             // transaction rows per tile
constexpr int kBK = 128;             // candidates per block
constexpr int kSlab = 64;            // items per staged slab
constexpr int kSteps = kSlab / 16;   // wmma k-steps per slab
constexpr int kWarps = 8;            // 4 along rows x 2 along candidates
constexpr int kThreads = kWarps * 32;

template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kLdm = 24;    // elements per staged row of one k-step
};
template <> struct Traits<signed char> {
  using Acc = int;
  static constexpr int kLdm = 16;
};

template <typename T>
__host__ __device__ constexpr int operand_elems() { return kSteps * kBN * Traits<T>::kLdm; }

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * 2 * operand_elems<T>() * sizeof(T)                  // 2 stages x (T, C) slabs
         + kWarps * 256 * sizeof(typename Traits<T>::Acc)        // epilogue scratch
         + kBK * sizeof(int);                                    // per-candidate block counts
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;   // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Stage rows [row0, row0 + 128) x items [i0, i0 + 64) of a (rows, ip)
// operand into dst laid out [step][row][ldm]; rows >= row_limit and items
// >= ip are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_slab(T* dst, const T* src, int row0, int row_limit,
                                           int ip, int i0) {
  constexpr int kLdm = Traits<T>::kLdm;
  constexpr int kPerChunk = 16 / sizeof(T);            // elements per 16-byte copy
  constexpr int kChunks = kSlab / kPerChunk;           // copies per row
  for (int idx = threadIdx.x; idx < kBN * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int col = (idx - r * kChunks) * kPerChunk;
    const int grow = row0 + r, gcol = i0 + col;
    const bool valid = grow < row_limit && gcol < ip;
    const T* g = valid ? src + (size_t)grow * ip + gcol : src;
    cp_async16(dst + (col >> 4) * kBN * kLdm + r * kLdm + (col & 15), g, valid);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
support_count_kernel(const T* __restrict__ t, const T* __restrict__ c,
                     const int32_t* __restrict__ lengths, int32_t* __restrict__ out,
                     int n, int k, int ip, int rows_per_split) {
  using Acc = typename Traits<T>::Acc;
  constexpr int kLdm = Traits<T>::kLdm;
  constexpr int kOperand = operand_elems<T>();

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);  // [2][T slab, C slab]
  Acc* scratch = reinterpret_cast<Acc*>(smem_raw + 2 * 2 * kOperand * sizeof(T));
  int* block_count = reinterpret_cast<int*>(scratch + kWarps * 256);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int cand0 = blockIdx.x * kBK;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  if (!__syncthreads_or(tid < kBK && cand0 + tid < k && lengths[cand0 + tid] >= 0)) return;
  if (tid < kBK) block_count[tid] = 0;

  // The epilogue's columns of this lane: 4 candidates, one per fragment column.
  Acc len_reg[4];
  int hits_reg[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cand = cand0 + warp_n * 64 + j * 16 + (lane & 15);
    len_reg[j] = static_cast<Acc>(cand < k ? lengths[cand] : -1);
    hits_reg[j] = 0;
  }

  const int ntiles = row_end > row_begin ? (row_end - row_begin + kBN - 1) / kBN : 0;
  const int nslabs = (ip + kSlab - 1) / kSlab;
  const int total = ntiles * nslabs;

  auto load = [&](int it) {
    const int tile = it / nslabs, slab = it - tile * nslabs;
    T* a = stages + (it & 1) * 2 * kOperand;
    stage_slab<T>(a, t, row_begin + tile * kBN, row_end, ip, slab * kSlab);
    stage_slab<T>(a + kOperand, c, cand0, k, ip, slab * kSlab);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[m][j], static_cast<Acc>(0));

  if (total > 0) load(0);
  cp_async_commit();
  __syncthreads();  // block_count zeroed before any shared atomic

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load(it + 1);
    cp_async_commit();
    cp_async_wait1();  // slab `it` has landed
    __syncthreads();

    const T* a = stages + (it & 1) * 2 * kOperand;
    const T* b = a + kOperand;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wmma::load_matrix_sync(fa[m], a + s * kBN * kLdm + (warp_m * 32 + m * 16) * kLdm, kLdm);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], b + s * kBK * kLdm + (warp_n * 64 + j * 16) * kLdm, kLdm);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[m][j], fa[m], fb[j], acc[m][j]);
    }

    const int tile = it / nslabs;
    if (it - tile * nslabs == nslabs - 1) {
      // Epilogue of one row tile: compare with len, sum the hits per column.
      Acc* sc = scratch + warp * 256;
      const int rows_here = row_end - (row_begin + tile * kBN);
      const int col = lane & 15, r0 = (lane >> 4) * 8;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(sc, acc[m][j], 16, wmma::mem_row_major);
          __syncwarp();
          const int row_base = warp_m * 32 + m * 16 + r0;
          int hits = 0;
#pragma unroll
          for (int r = 0; r < 8; ++r)
            hits += (row_base + r < rows_here && sc[(r0 + r) * 16 + col] == len_reg[j]) ? 1 : 0;
          hits += __shfl_down_sync(0xFFFFFFFFu, hits, 16);
          hits_reg[j] += hits;  // meaningful in lanes 0..15
          __syncwarp();
          wmma::fill_fragment(acc[m][j], static_cast<Acc>(0));
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait0();

  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (hits_reg[j]) atomicAdd(block_count + warp_n * 64 + j * 16 + lane, hits_reg[j]);
  }
  __syncthreads();
  if (tid < kBK && cand0 + tid < k && block_count[tid])
    atomicAdd(out + cand0 + tid, block_count[tid]);
}

template <typename T>
cudaError_t launch_typed(const void* t, const void* c, const int32_t* len, int32_t* out,
                         int n, int k, int ip, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(support_count_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_per_split = ((n + splits - 1) / splits + kBN - 1) / kBN * kBN;
  const int real_splits = (n + rows_per_split - 1) / rows_per_split;
  dim3 grid((k + kBK - 1) / kBK, real_splits);
  support_count_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(c), len, out, n, k, ip, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// t (n, ip), c (k, ip) {0,1} operands, row-major, 16-byte aligned, with ip a
// multiple of 16; dtype 0 = bf16, 1 = int8.  lengths (k,) int32; out (k,)
// int32, zeroed by the caller.  splits: transaction splits (grid.y).
// Returns cudaGetLastError() after the launch.
extern "C" int support_count_launch(const void* t, const void* c, const void* lengths, void* out,
                                    int n, int k, int ip, int dtype, int splits, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (ip <= 0 || ip % 16 != 0 || splits <= 0 || splits > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(t) & 15) || (reinterpret_cast<uintptr_t>(c) & 15))
    return (int)cudaErrorMisalignedAddress;
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch_typed<__nv_bfloat16>(t, c, lp, op, n, k, ip, splits, s)
      : launch_typed<signed char>(t, c, lp, op, n, k, ip, splits, s);
  return (int)err;
}
