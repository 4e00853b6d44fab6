// K1: candidate-support counting over packed bitsets, for sm_90a.
//
// Replaces src/repro/kernels/support_count_packed.py::support_count_packed_pallas
// (the Pallas kernel `_kernel`).  Computes, exactly,
//
//   counts[k] = #{ n : for all w, t[n,w] & c[k,w] == c[k,w] }   (len[k] >= 0)
//
// in two modes: and_cmp (a candidate is contained in a row iff no word is
// violated, masked by len >= 0) and popcount (sum_w popc(t & c) == len).
//
// What bounds it on this card: integer issue, not bytes.  At the main
// path's level-2 pass (N = 100,000 rows, Kp = 65,536 candidates, W = 32
// words) it does 2.1e11 word tests over 21 MB of operands, far above the
// card's int-op-per-byte line.  The design therefore spends nothing on
// memory and everything on keeping the test loop tight:
//   * grid = (candidate tiles of 128, transaction splits); each thread owns
//     one candidate and keeps its words (a chunk of up to 32) in registers;
//   * the block stages a tile of 32 transaction rows x WC words in shared
//     memory with coalesced (16-byte where aligned) loads; every thread of
//     a warp reads the same word, so shared reads are broadcasts;
//   * and_cmp folds a word test into one bitwise op (v |= (t & c) ^ c),
//     popcount into popc + add;
//   * one int32 atomicAdd per candidate per block into a zeroed output:
//     integer atomics commute, so the counts are exact and deterministic.
// Ragged N, K and W are masked here; the wrapper pads nothing.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // candidates per block
constexpr int kRows = 32;      // transaction rows per staged tile

template <int WC, bool POPCOUNT>
__global__ void __launch_bounds__(kThreads)
support_count_packed_kernel(const uint32_t* __restrict__ t,
                            const uint32_t* __restrict__ c,
                            const int32_t* __restrict__ lengths,
                            int32_t* __restrict__ out,
                            int n, int k, int w, int rows_per_split, int vec4) {
  __shared__ __align__(16) uint32_t tile[kRows][WC];

  const int cand = blockIdx.x * kThreads + threadIdx.x;
  const bool live = cand < k;
  const int len = live ? lengths[cand] : -1;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int nchunks = (w + WC - 1) / WC;

  uint32_t creg[WC];
  auto load_candidate = [&](int w0) {
#pragma unroll
    for (int j = 0; j < WC; ++j) {
      const int wj = w0 + j;
      creg[j] = (live && wj < w) ? c[(size_t)cand * w + wj] : 0u;
    }
  };
  if (nchunks == 1) load_candidate(0);

  int count = 0;
  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    const int rows_here = min(kRows, row_end - r0);
    uint32_t alive = 0xFFFFFFFFu;  // and_cmp: rows with no violated word yet
    int pop[POPCOUNT ? kRows : 1];
    if (POPCOUNT) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) pop[r] = 0;
    }

    for (int ch = 0; ch < nchunks; ++ch) {
      const int w0 = ch * WC;
      if (nchunks > 1) load_candidate(w0);
      __syncthreads();  // the previous tile has been read by every thread
      if (vec4 && (WC % 4) == 0) {
        for (int idx = threadIdx.x; idx < kRows * WC / 4; idx += kThreads) {
          const int r = (idx * 4) / WC, j = (idx * 4) % WC;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (r < rows_here && w0 + j < w)
            v = *reinterpret_cast<const uint4*>(t + (size_t)(r0 + r) * w + w0 + j);
          *reinterpret_cast<uint4*>(&tile[r][j]) = v;
        }
      } else {
        for (int idx = threadIdx.x; idx < kRows * WC; idx += kThreads) {
          const int r = idx / WC, j = idx % WC;
          tile[r][j] = (r < rows_here && w0 + j < w) ? t[(size_t)(r0 + r) * w + w0 + j] : 0u;
        }
      }
      __syncthreads();

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (POPCOUNT) {
          int p = 0;
#pragma unroll
          for (int j = 0; j < WC; ++j) p += __popc(tile[r][j] & creg[j]);
          pop[r] += p;
        } else {
          uint32_t v = 0u;
#pragma unroll
          for (int j = 0; j < WC; ++j) v |= (tile[r][j] & creg[j]) ^ creg[j];
          if (v) alive &= ~(1u << r);
        }
      }
    }

    const uint32_t row_mask = rows_here == 32 ? 0xFFFFFFFFu : ((1u << rows_here) - 1u);
    if (POPCOUNT) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) count += (r < rows_here && pop[r] == len) ? 1 : 0;
    } else {
      count += __popc(alive & row_mask);
    }
  }

  if (!POPCOUNT && len < 0) count = 0;
  if (live && count) atomicAdd(out + cand, count);
}

template <int WC>
cudaError_t launch_wc(const uint32_t* t, const uint32_t* c, const int32_t* len, int32_t* out,
                      int n, int k, int w, int mode, int splits, cudaStream_t stream, int vec4) {
  const int rows_per_split = ((n + splits - 1) / splits + kRows - 1) / kRows * kRows;
  const int real_splits = rows_per_split ? (n + rows_per_split - 1) / rows_per_split : 1;
  dim3 grid((k + kThreads - 1) / kThreads, real_splits > 0 ? real_splits : 1);
  if (mode == 1)
    support_count_packed_kernel<WC, true><<<grid, kThreads, 0, stream>>>(
        t, c, len, out, n, k, w, rows_per_split, vec4);
  else
    support_count_packed_kernel<WC, false><<<grid, kThreads, 0, stream>>>(
        t, c, len, out, n, k, w, rows_per_split, vec4);
  return cudaGetLastError();
}

}  // namespace

// t (n, w), c (k, w) uint32 words; lengths (k,) int32; out (k,) int32, zeroed
// by the caller.  mode: 0 = and_cmp, 1 = popcount.  splits: transaction
// splits (grid.y).  Returns cudaGetLastError() after the launch.
extern "C" int support_count_packed_launch(const void* t, const void* c, const void* lengths,
                                           void* out, int n, int k, int w, int mode,
                                           int splits, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (w <= 0 || splits <= 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  const int vec4 = (w % 4 == 0) && ((reinterpret_cast<uintptr_t>(t) & 15) == 0);
  const auto* tp = static_cast<const uint32_t*>(t);
  const auto* cp = static_cast<const uint32_t*>(c);
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w <= 4) err = launch_wc<4>(tp, cp, lp, op, n, k, w, mode, splits, s, vec4);
  else if (w <= 8) err = launch_wc<8>(tp, cp, lp, op, n, k, w, mode, splits, s, vec4);
  else if (w <= 16) err = launch_wc<16>(tp, cp, lp, op, n, k, w, mode, splits, s, vec4);
  else err = launch_wc<32>(tp, cp, lp, op, n, k, w, mode, splits, s, vec4);
  return (int)err;
}
