// K2: batched basket -> rule matching with per-item score fan-out, for sm_90a.
//
// Replaces src/repro/kernels/rule_match.py::rule_match_pallas (the Pallas
// kernel `_kernel`).  Computes
//
//   out[b, i] = sum_r [a_r subset of basket_b] * [len_r >= 0] * s_r * cons_r[i]
//
// for baskets b (B, W), antecedents a and consequents c (R, W) as uint32
// words, lengths (R,) int32 and scores (R,) float32; out is (B, 32W) float32.
//
// What bounds it on this card: the fan-out, 2*B*R*32W fp32 operations over
// a few MB of operands, so arithmetic rather than bytes.  The design:
//   * one block per (16-basket tile, 128-item tile); 256 threads, each owns
//     one item column and 8 baskets, accumulating in fp32 registers;
//   * the block loops over all R in chunks of 32 rules staged in shared
//     memory (antecedent words, length, score and the 4 consequent words of
//     its item tile), computes the masked weights w[b, r] for the chunk into
//     shared memory with a word-violation test, then adds w[b, r] *
//     bit(c_r, i) for r in ascending order;
//   * no float atomics and a fixed summation order: the result is the same
//     bits on every run, which the serving tier's bit-identity contract
//     needs; full fp32 (FMA with a {0,1} factor is an exact add), no
//     tensor-core rounding of the scores.
// Ragged B, R and W are masked here.  The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBaskets = 16;  // baskets per block
constexpr int kItems = 128;   // items per block (4 words)
constexpr int kItemWords = kItems / 32;
constexpr int kRules = 32;    // rules per staged chunk
constexpr int kPerThread = kBaskets / (kThreads / kItems);  // baskets per thread

__global__ void __launch_bounds__(kThreads)
rule_match_kernel(const uint32_t* __restrict__ baskets,
                  const uint32_t* __restrict__ ante,
                  const int32_t* __restrict__ lengths,
                  const uint32_t* __restrict__ cons,
                  const float* __restrict__ scores,
                  float* __restrict__ out, int nb, int nr, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  // weights first so float4 reads stay 16-byte aligned
  float* wts = reinterpret_cast<float*>(smem);                        // [kBaskets][kRules]
  uint32_t* cons_s = reinterpret_cast<uint32_t*>(wts + kBaskets * kRules);  // [kRules][kItemWords]
  const int astride = w | 1;                                          // odd: no bank conflicts
  uint32_t* bsk_s = cons_s + kRules * kItemWords;                     // [kBaskets][w]
  uint32_t* ante_s = bsk_s + kBaskets * w;                            // [kRules][astride]

  const int item0 = blockIdx.x * kItems;
  const int word0 = blockIdx.x * kItemWords;
  const int b0 = blockIdx.y * kBaskets;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < kBaskets * w; idx += kThreads) {
    const int bb = idx / w, j = idx % w;
    bsk_s[idx] = (b0 + bb < nb) ? baskets[(size_t)(b0 + bb) * w + j] : 0u;
  }

  const int il = tid % kItems;      // item column owned by this thread
  const int bg = tid / kItems;      // basket group: baskets bg, bg+2, ...
  const int iw = il / 32, ibit = il % 32;
  float acc[kPerThread];
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) acc[m] = 0.0f;

  for (int r0 = 0; r0 < nr; r0 += kRules) {
    __syncthreads();  // previous chunk fully consumed (and baskets staged)
    for (int idx = tid; idx < kRules * w; idx += kThreads) {
      const int r = idx / w, j = idx % w;
      ante_s[r * astride + j] = (r0 + r < nr) ? ante[(size_t)(r0 + r) * w + j] : 0u;
    }
    for (int idx = tid; idx < kRules * kItemWords; idx += kThreads) {
      const int r = idx / kItemWords, j = idx % kItemWords;
      cons_s[idx] = (r0 + r < nr && word0 + j < w) ? cons[(size_t)(r0 + r) * w + word0 + j] : 0u;
    }
    __syncthreads();

    // masked weights for this chunk: lanes of a warp take consecutive rules
    for (int p = tid; p < kBaskets * kRules; p += kThreads) {
      const int r = p % kRules, bb = p / kRules;
      float wt = 0.0f;
      if (r0 + r < nr) {
        const uint32_t* a = ante_s + r * astride;
        const uint32_t* bk = bsk_s + bb * w;
        uint32_t v = 0u;
        for (int j = 0; j < w; ++j) v |= (bk[j] & a[j]) ^ a[j];
        const bool matched = (v == 0u) && (lengths[r0 + r] >= 0);
        wt = (matched ? 1.0f : 0.0f) * scores[r0 + r];
      }
      wts[bb * kRules + r] = wt;
    }
    __syncthreads();

    // fan-out: ascending r, one exact fp32 add per set consequent bit
#pragma unroll 2
    for (int r = 0; r < kRules; r += 4) {
      const float f0 = (float)((cons_s[(r + 0) * kItemWords + iw] >> ibit) & 1u);
      const float f1 = (float)((cons_s[(r + 1) * kItemWords + iw] >> ibit) & 1u);
      const float f2 = (float)((cons_s[(r + 2) * kItemWords + iw] >> ibit) & 1u);
      const float f3 = (float)((cons_s[(r + 3) * kItemWords + iw] >> ibit) & 1u);
#pragma unroll
      for (int m = 0; m < kPerThread; ++m) {
        const float4 wv = *reinterpret_cast<const float4*>(wts + (bg + 2 * m) * kRules + r);
        acc[m] = fmaf(wv.x, f0, acc[m]);
        acc[m] = fmaf(wv.y, f1, acc[m]);
        acc[m] = fmaf(wv.z, f2, acc[m]);
        acc[m] = fmaf(wv.w, f3, acc[m]);
      }
    }
  }

  const int item = item0 + il;
  if (item < 32 * w) {
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const int b = b0 + bg + 2 * m;
      if (b < nb) out[(size_t)b * (32 * w) + item] = acc[m];
    }
  }
}

}  // namespace

// Dynamic shared memory the launch needs for w words.
extern "C" long long rule_match_smem_bytes(int w) {
  const long long astride = w | 1;
  return 4LL * (kBaskets * kRules + kRules * kItemWords + (long long)kBaskets * w +
                (long long)kRules * astride);
}

// baskets (nb, w), ante / cons (nr, w) uint32 words; lengths (nr,) int32;
// scores (nr,) float32; out (nb, 32w) float32.  Returns cudaGetLastError().
extern "C" int rule_match_launch(const void* baskets, const void* ante, const void* lengths,
                                 const void* cons, const void* scores, void* out,
                                 int nb, int nr, int w, void* stream) {
  if (nb <= 0) return 0;
  if (w <= 0 || nr < 0) return (int)cudaErrorInvalidValue;
  const long long smem = rule_match_smem_bytes(w);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rule_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((32 * w + kItems - 1) / kItems, (nb + kBaskets - 1) / kBaskets);
  rule_match_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(baskets), static_cast<const uint32_t*>(ante),
      static_cast<const int32_t*>(lengths), static_cast<const uint32_t*>(cons),
      static_cast<const float*>(scores), static_cast<float*>(out), nb, nr, w);
  return (int)cudaGetLastError();
}
