// K1: candidate-support counting over packed bitsets, for sm_90a.
//
// Replaces src/repro/kernels/support_count_packed.py::support_count_packed_pallas
// (the Pallas kernel `_kernel`).  Computes, exactly, for t (N, W) and
// c (K, W) uint32 words and len (K,) int32:
//
//   and_cmp:  counts[k] = #{ n : for all w, t[n,w] & c[k,w] == c[k,w] }  if len[k] >= 0, else 0
//   popcount: counts[k] = #{ n : sum_w popc(t[n,w] & c[k,w]) == len[k] }
//
// What bounds it on this card: integer issue.  Tested row by row, a pass
// costs N x K x W word tests (2.1e11 at the main path's level-2 pass,
// N = 100,000, Kp = 65,536, W = 32), and even the words where a candidate
// holds a bit cost 7.9e9.  Item-major bitmaps cut that to one AND (or
// popc) per candidate item per 32 rows: 2.6e8 at that pass.  So:
//   * candidate_meta_kernel, once per launch, one thread per candidate:
//     its first kSlots item ids into the scratch, and from its item count m
//     and len a code for the count kernel: 0 (counts 0: len < 0, or a
//     popcount length above m), 1 + m for a candidate counted on the
//     bitmaps (and_cmp, or popcount with len == m, and m <= kSlots), or
//     kGeneral for the rest (more than kSlots items, or a popcount length
//     below m);
//   * bitmap_kernel, per slab of rows: transposes the slab's (rows, W)
//     words into (32 W, ldb) item bitmaps in the scratch, bit r of word j
//     of item i being row 32 j + r of the slab.  A block stages 512 rows x
//     8 words in shared memory; a warp turns 32 rows of one word into the
//     32 items' bitmap words with one __ballot_sync per item bit, and the
//     block writes each item's 16 words contiguously.  Rows past the slab
//     are zero bits;
//   * count_kernel, per slab: one warp per candidate, its lanes over the
//     bitmap words in 16-byte loads, so a candidate's items are read
//     coalesced and the 8 candidates of a block (sorted by their first item
//     at level 2) meet the same first bitmap in L1.  It ANDs its items'
//     words and adds their popcount.  Bits past the slab's last row are
//     masked: a zero bit there would count for an empty candidate.  A
//     kGeneral candidate tests its rows one per lane on the words where it
//     holds a bit (exact in both modes, and slow);
//   * each warp publishes its count with one int32 atomicAdd into a zeroed
//     output.  Integer adds commute, so the counts are exact and the same
//     on every run.
// The bitmaps of a slab take 128 W bytes a word of 32 rows; the wrapper
// sizes the slab (slab_words) so that its scratch stays under a cap, or
// holds 1,024 rows where even those pass the cap, and the launch walks the
// slabs in order on one stream.  At the main path's
// pass the bitmaps are 12.8 MB in one slab and stay in the 50 MB L2.
// Ragged N, K and W are masked here; the kernels allocate nothing and
// launch on the caller's stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;             // item ids a candidate counted on the bitmaps may have
constexpr int kGeneral = kSlots + 2;  // code: counted row by row
constexpr int kWarps = 8;             // candidates per count block
constexpr int kTileRowBlocks = 16;    // 32-row blocks a bitmap block transposes
constexpr int kTileWords = 8;         // words a bitmap block transposes
constexpr int kWordsPerStep = 128;    // bitmap words a warp reads per step (4 per lane)

long long align16(long long x) { return (x + 15) / 16 * 16; }

// The scratch: codes (K,) int32, ids (K, kSlots) uint32, then the bitmaps.
long long meta_bytes(int k) { return align16(4LL * k) + 4LL * kSlots * k; }

__global__ void candidate_meta_kernel(const uint32_t* __restrict__ c, const int32_t* __restrict__ lengths,
                                      int32_t* __restrict__ codes, uint32_t* __restrict__ ids, int k,
                                      int w, int popcount) {
  const int cand = blockIdx.x * blockDim.x + threadIdx.x;
  if (cand >= k) return;
  const uint32_t* row = c + (size_t)cand * w;
  uint32_t* mine = ids + (size_t)cand * kSlots;
  long long m = 0;
  for (int j = 0; j < w; ++j) {
    for (uint32_t x = __ldg(row + j); x; x &= x - 1u, ++m)
      if (m < kSlots) mine[m] = 32u * j + (__ffs(x) - 1);
  }
  const int len = lengths[cand];
  int code;
  if (len < 0 || (popcount && len > m)) code = 0;
  else if (popcount && len < m) code = kGeneral;
  else code = m <= kSlots ? 1 + (int)m : kGeneral;
  codes[cand] = code;
}

// Rows [lo, hi) of t as item bitmaps bm (32 w, ldb): bit r of bm[i][j] is
// bit i of row lo + 32 j + r, zero past hi.
__global__ void __launch_bounds__(32 * kTileWords)
bitmap_kernel(const uint32_t* __restrict__ t, uint32_t* __restrict__ bm, long long lo, long long hi, int w,
              int ldb) {
  __shared__ uint32_t in_s[32 * kTileRowBlocks][kTileWords + 1];
  __shared__ uint32_t out_s[32 * kTileWords][kTileRowBlocks + 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb0 = blockIdx.x * kTileRowBlocks;
  const int word_tiles = (w + kTileWords - 1) / kTileWords;
  for (int wt = blockIdx.y; wt < word_tiles; wt += gridDim.y) {
    const int w0 = wt * kTileWords;
    __syncthreads();  // the previous tile's out_s has been written out
    for (int idx = tid; idx < 32 * kTileRowBlocks * kTileWords; idx += 32 * kTileWords) {
      const int r = idx / kTileWords, j = idx % kTileWords;
      const long long row = lo + 32LL * rb0 + r;
      in_s[r][j] = (row < hi && w0 + j < w) ? __ldg(t + row * w + w0 + j) : 0u;
    }
    __syncthreads();
    for (int rb = 0; rb < kTileRowBlocks; ++rb) {
      const uint32_t x = in_s[32 * rb + lane][warp];
      uint32_t bits = 0u;
      if (__any_sync(0xffffffffu, x)) {
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const uint32_t v = __ballot_sync(0xffffffffu, (x >> b) & 1u);
          if (lane == b) bits = v;
        }
      }
      out_s[32 * warp + lane][rb] = bits;
    }
    __syncthreads();
    for (int idx = tid; idx < 32 * kTileWords * kTileRowBlocks; idx += 32 * kTileWords) {
      const int il = idx / kTileRowBlocks, rb = idx % kTileRowBlocks;
      if (w0 + il / 32 < w) bm[(size_t)(32 * w0 + il) * ldb + rb0 + rb] = out_s[il][rb];
    }
  }
}

// One warp per candidate over the bitmap words [j0, j1) of a slab whose
// rows are [lo, hi) (nw = ceil((hi - lo) / 32) words hold them).
__global__ void __launch_bounds__(32 * kWarps)
count_kernel(const uint32_t* __restrict__ t, const uint32_t* __restrict__ c,
             const int32_t* __restrict__ lengths, const int32_t* __restrict__ codes,
             const uint32_t* __restrict__ ids, const uint32_t* __restrict__ bm, int32_t* __restrict__ out,
             int k, int w, long long lo, long long hi, int ldb, int words_per_split, int popcount) {
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cand >= k) return;
  const int code = codes[cand];
  if (code == 0) return;
  const long long rows = hi - lo;
  const int nw = (int)((rows + 31) / 32);
  const int j0 = blockIdx.y * words_per_split;
  const int j1 = min(nw, j0 + words_per_split);
  if (j0 >= j1) return;
  int cnt = 0;
  if (code == kGeneral) {
    // row by row, on the words where the candidate holds a bit
    const uint32_t* cr = c + (size_t)cand * w;
    const int len = lengths[cand];
    const long long r_end = min(hi, lo + 32LL * j1);
    for (long long n = lo + 32LL * j0 + lane; n < r_end; n += 32) {
      const uint32_t* tr = t + (size_t)n * w;
      int pop = 0;
      bool all = true;
      for (int j = 0; j < w; ++j) {
        const uint32_t cw = __ldg(cr + j);
        if (cw) {
          const uint32_t x = __ldg(tr + j) & cw;
          pop += __popc(x);
          all &= x == cw;
        }
      }
      cnt += popcount ? (pop == len) : all;
    }
  } else {
    const int m = code - 1;
    const uint32_t* row[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) row[s] = bm + (size_t)(s < m ? ids[(size_t)cand * kSlots + s] : 0u) * ldb;
    const int full = (int)(rows / 32);  // words whose 32 rows all lie in the slab
    const uint32_t tail = (1u << (rows % 32)) - 1u;
    for (int j = j0 + 4 * lane; j < j1; j += kWordsPerStep) {
      uint4 x = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < m) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row[s] + j));
          x.x &= v.x;
          x.y &= v.y;
          x.z &= v.z;
          x.w &= v.w;
        }
      }
      auto mask = [&](int jj) { return jj < full ? ~0u : (jj == full ? tail : 0u); };
      cnt += __popc(x.x & mask(j)) + __popc(x.y & mask(j + 1)) + __popc(x.z & mask(j + 2)) +
             __popc(x.w & mask(j + 3));
    }
  }
  cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
  if (lane == 0 && cnt) atomicAdd(out + cand, cnt);
}

}  // namespace

// Bytes of device scratch a launch needs for k candidates of w words when
// each slab spans slab_words words of 32 rows (a multiple of 32).
extern "C" long long support_count_packed_scratch_bytes(int k, int w, int slab_words) {
  return align16(meta_bytes(k)) + 128LL * w * slab_words;
}

// t (n, w), c (k, w) uint32 words; lengths (k,) int32; out (k,) int32, zeroed
// by the caller; scratch of support_count_packed_scratch_bytes(k, w,
// slab_words) bytes, 16-byte aligned.  mode: 0 = and_cmp, 1 = popcount.  sms:
// the card's SM count, which sizes the count grid.  Returns
// cudaGetLastError() after the launches.
extern "C" int support_count_packed_launch(const void* t, const void* c, const void* lengths, void* out,
                                           void* scratch, int n, int k, int w, int mode, int slab_words,
                                           int sms, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (w <= 0 || (mode != 0 && mode != 1) || slab_words <= 0 || slab_words % 32 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const uint32_t*>(t);
  const auto* cp = static_cast<const uint32_t*>(c);
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<int32_t*>(out);
  auto* base = static_cast<unsigned char*>(scratch);
  auto* codes = reinterpret_cast<int32_t*>(base);
  auto* ids = reinterpret_cast<uint32_t*>(base + align16(4LL * k));
  auto* bm = reinterpret_cast<uint32_t*>(base + align16(meta_bytes(k)));

  candidate_meta_kernel<<<(k + 255) / 256, 256, 0, s>>>(cp, lp, codes, ids, k, w, mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long count_blocks = (k + kWarps - 1) / kWarps;
  if (count_blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int word_tiles = (w + kTileWords - 1) / kTileWords;
  for (long long lo = 0; lo < n; lo += 32LL * slab_words) {
    const long long hi = lo + 32LL * slab_words < n ? lo + 32LL * slab_words : n;
    const int nw = (int)((hi - lo + 31) / 32);
    const int ldb = (nw + 31) / 32 * 32;
    bitmap_kernel<<<dim3(ldb / kTileRowBlocks, word_tiles < 65535 ? word_tiles : 65535), 32 * kTileWords, 0, s>>>(
        tp, bm, lo, hi, w, ldb);
    // enough warps for 64 on each SM, never a split below one warp step
    const long long want = ((long long)sms * 64 + k - 1) / k;
    const int max_splits = (nw + kWordsPerStep - 1) / kWordsPerStep;
    int splits = (int)(want < max_splits ? want : max_splits);
    splits = splits < 1 ? 1 : (splits > 65535 ? 65535 : splits);
    const int per_split = ((nw + splits - 1) / splits + kWordsPerStep - 1) / kWordsPerStep * kWordsPerStep;
    splits = (nw + per_split - 1) / per_split;
    count_kernel<<<dim3((unsigned)count_blocks, splits), 32 * kWarps, 0, s>>>(
        tp, cp, lp, codes, ids, bm, op, k, w, lo, hi, ldb, per_split, mode);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
