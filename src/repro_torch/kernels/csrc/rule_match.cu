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
// The contract, bit for bit: each out[b, i] starts at +0 and adds s_r, one
// rounded fp32 add at a time, for the matched rules with bit i in their
// consequent, in ascending r.  A dense fan-out in ascending r (an FMA with a
// {0,1} factor is an exact no-op or that one add) gives the same bits, and
// so does kernels/ref.py::rule_match_ordered.  The sum is the same on every
// run and a basket's row does not depend on the batch it came in, which the
// serving tier's bit-identity contract needs.  So: no float atomics, no tree
// over rules, no tensor cores for the scores.
//
// What bounds it on this card: the matched work is sparse.  At the main
// shape (B = 1,024, R = 43,520 rules, W = 32) about 1.8e-5 of the dense
// 2*B*R*32W fan-out is matched: about 1e6 fp32 adds and about 1.3e8
// antecedent-word tests per batch.  The rulebook is 11 MB and stays
// L2-resident.  Neither HBM nor the fp32 rate bounds it; the latency and the
// shared-memory traffic of each basket's walk over the rules do.  A dense
// fan-out, or skipping 32-rule chunks where nothing matched (a 16 x 32 chunk
// holds about 9 matches), does 10^4 times the needed work, so the work is
// sparse per basket and ordered:
//   * compact_rules_kernel, once per launch, one warp per rule: the item
//     ids of the antecedent and of the consequent, kMaxItems slots of each
//     (four uint16 in 8 bytes), the unused slots repeating the first item.
//     Rows with len < 0 are marked dead; a side with more than kMaxItems
//     items is marked wide and read whole from the rulebook where it is
//     used.  A side holding an item id past 65,535, which a uint16 slot
//     cannot hold, is marked far and keeps its ids whole in far slots (four
//     uint32), read beside the wide sides on the rare path; so the compact
//     rows staged per chunk keep 8 bytes a side at every width, and a
//     rulebook over millions of items (FIMI's webdocs has 5,267,656) is
//     not read whole;
//   * rule_match_kernel: a block owns kWarps baskets, one warp each, and
//     walks R in ascending chunks of kChunk rules.
//     Each chunk's slots, counts and scores are copied into shared memory
//     with cp.async while the block works on the chunk before (two buffers);
//   * match: lane l of a basket's warp tests rules g + l, g + 32 + l, ... on
//     the antecedent's items only, without a branch (one 8-byte read and
//     four basket-word reads a rule); __ballot_sync and __popc turn the hits
//     into the chunk's list of matched rule ids in ascending order.  The
//     list is bounded by the chunk, so nothing overflows even when every
//     rule matches;
//   * fan-out, 32 matched rules at a time: lane t reads rule t's slots and
//     score and writes its consequent items to a list in rule order (a warp
//     prefix sum of the item counts gives each lane its place); each item i
//     is then queued, in that order, for lane i % 32 (__match_any_sync ranks
//     the items of one owner), and every lane applies its queue in order to
//     its items of the basket's row in shared memory.  Each item has one owner lane and its
//     adds stay sequential in r, and no step walks the rules one at a time:
//     the read-add-write chains of the 32 lanes run side by side.  A group
//     holding a consequent wider than the slots goes rule by rule instead.
//     The row is carried across chunks;
//   * the row is written to out once, coalesced, at the end.
// Any W: a block holds the row of one window of at most kWindow words
// (2,048 items), and the grid has one block per (basket group, window).
// Each block matches its baskets against every rule, because a match needs
// the whole antecedent, and fans out only the consequent items in its
// window, so each (basket, item) sum is still the same chain of adds in
// ascending r.  Up to kWindow words there is one window, the window test
// compiles out and the baskets' words are staged in shared memory
// (kTiled = false); above it the baskets' words are read from global
// memory, and the far slots keep the match of a rule independent of W.
// Ragged B, R and W are masked here; 32·W must fit in an int.  The kernels
// allocate nothing (the wrapper passes the scratch) and launch on the
// caller's stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;       // rules staged per chunk
constexpr int kMaxItems = 4;       // item slots per antecedent and per consequent (uint16 each)
constexpr int kUnroll = 4;         // 32-rule groups tested together
constexpr int kRowStride = 33;     // floats per word in a row: 32 items + 1 pad
constexpr int kQueue = 32 * kMaxItems;  // queue entries a lane may get from 32 rules
constexpr int kBatch = 4;          // fan-out reads issued before their writes
constexpr int kWindow = 64;        // words of the basket row one block holds
constexpr int kWarps = 8;          // baskets a block, one warp each
constexpr int kDead = -1;          // len < 0: never matches
constexpr int kWide = kMaxItems + 1;  // more than kMaxItems items
constexpr int kFar = 8;            // + the item count: an id past 65,535, kept whole in the far slots

// The compact rules' scratch, one entry per rule: the far slots of the
// antecedents and of the consequents (read only for a side coded
// kFar + n), the item slots of the antecedents, of the consequents, then
// the item counts, each count array padded to 16 rules so that it is
// copied 4 bytes at a time.
struct Compact {
  uint4* af;
  uint4* cf;
  uint2* ai;
  uint2* ci;
  signed char* an;
  signed char* cn;
};

long long padded(int nr) { return (nr + 15LL) / 16 * 16; }

long long scratch_bytes(int nr) { return 48LL * nr + 2 * padded(nr); }

Compact carve(void* scratch, int nr) {
  Compact c;
  c.af = static_cast<uint4*>(scratch);
  c.cf = c.af + nr;
  c.ai = reinterpret_cast<uint2*>(c.cf + nr);
  c.ci = c.ai + nr;
  c.an = reinterpret_cast<signed char*>(c.ci + nr);
  c.cn = c.an + padded(nr);
  return c;
}

// Dynamic shared memory of one block holding a row of wt words and
// `staged` words of each basket: two staged chunks (slots, scores), the
// baskets' rows and words, their fan-out item lists and queue counts, match
// lists, the two chunks' item counts and the lanes' fan-out queues.  At
// most 165 KB (wt = staged = kWindow).
long long smem_bytes(int wt, int staged) {
  return 2 * (8LL * 2 * kChunk + 4LL * kChunk + 2LL * kChunk) +
         4LL * kWarps * ((long long)wt * kRowStride + staged + kQueue + 32) + 2LL * kWarps * kChunk +
         (long long)kWarps * kQueue * 32;
}

__device__ __forceinline__ uint32_t slot(uint2 s, int k) {
  const uint32_t half = k < 2 ? s.x : s.y;
  return (k & 1) ? half >> 16 : half & 0xffffu;
}

// The item ids of one row in kMaxItems uint16 slots and in kMaxItems
// uint32 far slots, the unused ones repeating the first, found by one warp:
// its lanes read the row 32 words at a time (x0: this lane's word of the
// first 32, already loaded), and the warp takes the words that hold a bit
// in order, from a ballot, until it has more than kMaxItems items.
// Returns, in every lane, their count n, kFar + n when one of them does not
// fit a uint16 slot (an id past 65,535), or kWide when there are more than
// kMaxItems.
__device__ int compact_row(const uint32_t* __restrict__ row, int w, int lane, uint32_t x0, uint2* slots,
                           uint4* far_slots) {
  uint32_t it[kMaxItems] = {0u, 0u, 0u, 0u};
  int n = 0;
  for (int j0 = 0; j0 < w && n <= kMaxItems; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t x = j0 == 0 ? x0 : j < w ? __ldg(row + j) : 0u;
    for (unsigned nz = __ballot_sync(0xffffffffu, x != 0u); nz && n <= kMaxItems; nz &= nz - 1u) {
      const int src = __ffs(nz) - 1;
      for (uint32_t y = __shfl_sync(0xffffffffu, x, src); y; y &= y - 1u) {
        const uint32_t item = 32u * (j0 + src) + (__ffs(y) - 1);
#pragma unroll
        for (int k = 0; k < kMaxItems; ++k)
          if (k == n) it[k] = item;
        ++n;
      }
    }
  }
  bool far = false;
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) far |= it[k] > 0xffffu;
#pragma unroll
  for (int k = 1; k < kMaxItems; ++k)
    if (k >= n) it[k] = it[0];
  if (lane == 0) {
    *slots = make_uint2((it[0] & 0xffffu) | (it[1] << 16), (it[2] & 0xffffu) | (it[3] << 16));
    *far_slots = make_uint4(it[0], it[1], it[2], it[3]);
  }
  return n > kMaxItems ? kWide : (far ? kFar + n : n);
}

// One warp per rule; the length and both rows' first words load together.
__global__ void compact_rules_kernel(const uint32_t* __restrict__ ante,
                                     const int32_t* __restrict__ lengths,
                                     const uint32_t* __restrict__ cons, Compact c, int nr, int w) {
  const int r = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= nr) return;
  const uint32_t* a = ante + (size_t)r * w;
  const uint32_t* cr = cons + (size_t)r * w;
  const int len = lengths[r];
  const uint32_t a0 = lane < w ? __ldg(a + lane) : 0u;
  const uint32_t c0 = lane < w ? __ldg(cr + lane) : 0u;
  if (len < 0) {
    if (lane == 0) {
      c.an[r] = (signed char)kDead;
      c.cn[r] = 0;
      c.ai[r] = c.ci[r] = make_uint2(0u, 0u);
    }
    return;
  }
  const int an = compact_row(a, w, lane, a0, c.ai + r, c.af + r);
  const int cn = compact_row(cr, w, lane, c0, c.ci + r, c.cf + r);
  if (lane == 0) {
    c.an[r] = (signed char)an;
    c.cn[r] = (signed char)cn;
  }
}

// The match of the antecedents the uint16 slots do not hold, for rules
// g + 32q + lane of a chunk (rare, so kept out of line): a far one tests
// its far slots; the warp tests each wide one's words, 32 at a time, until
// one misses.  ok: bit q for rule g + 32q + lane; returned updated.
__device__ __noinline__ unsigned match_rare(unsigned ok, const uint32_t* bk, const signed char* an_s,
                                            const uint4* af, const uint32_t* ante, int r0, int g, int n,
                                            int w, int lane) {
  auto has = [&](uint32_t item) { return (bk[item >> 5] >> (item & 31u)) & 1u; };
  for (int q = 0; q < kUnroll; ++q) {
    const int lq = g + 32 * q;
    const int an = lq + lane < n ? an_s[lq + lane] : kDead;
    if (an > kFar) {
      const uint4 f = af[r0 + lq + lane];
      ok = (ok & ~(1u << q)) | ((has(f.x) & has(f.y) & has(f.z) & has(f.w)) << q);
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, an == kWide); todo; todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      const uint32_t* a = ante + (size_t)(r0 + lq + src) * w;
      bool hit = true;
      for (int k0 = 0; k0 < w && hit; k0 += 32) {
        const int k = k0 + lane;
        const uint32_t x = k < w ? __ldg(a + k) : 0u;
        hit = __all_sync(0xffffffffu, (bk[k < w ? k : 0] & x) == x);
      }
      if (lane == src) ok = (ok & ~(1u << q)) | ((unsigned)hit << q);
    }
  }
  return ok;
}

template <bool kTiled>
__global__ void __launch_bounds__(32 * kWarps)
rule_match_kernel(const uint32_t* __restrict__ baskets,
                  const uint32_t* __restrict__ ante,
                  const uint32_t* __restrict__ cons,
                  const float* __restrict__ scores, const Compact c,
                  float* __restrict__ out, int nb, int nr, int w, int wt) {
  constexpr int kThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = kTiled ? 0 : w;  // basket words staged per warp
  uint2* ai_b = reinterpret_cast<uint2*>(smem);                                  // [2][kChunk]
  uint2* ci_b = ai_b + 2 * kChunk;                                               // [2][kChunk]
  float* score_b = reinterpret_cast<float*>(ci_b + 2 * kChunk);                  // [2][kChunk]
  float* row_s = score_b + 2 * kChunk;                                           // [kWarps][wt][kRowStride]
  uint32_t* bsk_s = reinterpret_cast<uint32_t*>(row_s + (size_t)kWarps * wt * kRowStride);  // [kWarps][sw]
  uint32_t* item_s = bsk_s + (size_t)kWarps * sw;                                // [kWarps][kQueue]
  int* count_s = reinterpret_cast<int*>(item_s + kWarps * kQueue);               // [kWarps][32]
  uint16_t* list_s = reinterpret_cast<uint16_t*>(count_s + kWarps * 32);        // [kWarps][kChunk]
  signed char* an_b = reinterpret_cast<signed char*>(list_s + kWarps * kChunk);  // [2][kChunk]
  signed char* cn_b = an_b + 2 * kChunk;                                         // [2][kChunk]
  uint8_t* queue_s = reinterpret_cast<uint8_t*>(cn_b + 2 * kChunk);              // [kWarps][kQueue][32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // blocks walk the basket groups of window 0, then of window 1, ...
  const int groups = (nb + kWarps - 1) / kWarps;
  const int b0 = (blockIdx.x % groups) * kWarps;
  const int w0 = kTiled ? (blockIdx.x / groups) * wt : 0;  // the window's first word
  const int wn = kTiled ? min(wt, w - w0) : w;              // its words
  const bool live = b0 + warp < nb;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one

  for (int idx = tid; idx < kWarps * sw; idx += kThreads)  // bsk_s: [kWarps][w]
    bsk_s[idx] = (b0 + idx / w < nb) ? baskets[(size_t)b0 * w + idx] : 0u;
  for (int idx = tid; idx < kWarps * wt * kRowStride; idx += kThreads) row_s[idx] = 0.0f;
  for (int idx = tid; idx < kWarps * 32; idx += kThreads) count_s[idx] = 0;

  // the basket's words: staged in shared memory (known to the compiler as
  // such) at one window, else in global memory
  const uint32_t* bk = kTiled ? baskets + (live ? (size_t)(b0 + warp) * w : 0) : bsk_s + (size_t)warp * w;
  float* row = row_s + (size_t)warp * wt * kRowStride;
  uint16_t* list = list_s + warp * kChunk;
  uint8_t* queue_w = queue_s + warp * kQueue * 32;       // [kQueue][32 lanes]
  uint8_t* queue = queue_w + lane;                        // this lane's entry q at queue[32 * q]
  int* counts = count_s + warp * 32;
  uint32_t* items = item_s + warp * kQueue;
  auto has = [&](uint32_t item) { return (bk[item >> 5] >> (item & 31u)) & 1u; };
  // whether an item falls in this block's window
  auto mine = [&](uint32_t item) { return !kTiled || (item >> 5) - (uint32_t)w0 < (uint32_t)wn; };

  // cp.async of chunk r0 into buffer `buf`; the counts go 4 rules at a time
  auto stage = [&](int r0, int buf) {
    const int n = min(kChunk, nr - r0);
    for (int lr = tid; lr < n; lr += kThreads) {
      __pipeline_memcpy_async(ai_b + buf * kChunk + lr, c.ai + r0 + lr, 8);
      __pipeline_memcpy_async(ci_b + buf * kChunk + lr, c.ci + r0 + lr, 8);
      __pipeline_memcpy_async(score_b + buf * kChunk + lr, scores + r0 + lr, 4);
    }
    for (int lr = 4 * tid; lr < n; lr += 4 * kThreads) {
      __pipeline_memcpy_async(an_b + buf * kChunk + lr, c.an + r0 + lr, 4);
      __pipeline_memcpy_async(cn_b + buf * kChunk + lr, c.cn + r0 + lr, 4);
    }
    __pipeline_commit();
  };
  if (nr > 0) stage(0, 0);

  for (int r0 = 0, buf = 0; r0 < nr; r0 += kChunk, buf ^= 1) {
    const int n = min(kChunk, nr - r0);
    __syncthreads();  // the previous chunk consumed; baskets and rows initialised
    if (r0 + kChunk < nr) stage(r0 + kChunk, buf ^ 1);
    else __pipeline_commit();
    __pipeline_wait_prior(1);  // this chunk's copies have landed
    __syncthreads();
    if (!live) continue;
    const uint2* ai_s = ai_b + buf * kChunk;
    const uint2* ci_s = ci_b + buf * kChunk;
    const float* score_s = score_b + buf * kChunk;
    const signed char* an_s = an_b + buf * kChunk;
    const signed char* cn_s = cn_b + buf * kChunk;

    // match: the chunk's hits for this warp's basket, as ascending rule ids
    int cnt = 0;
    for (int g = 0; g < n; g += 32 * kUnroll) {
      unsigned ok = 0u;  // bit q: rule g + 32q + lane matches
      bool wide = false;
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int lr = g + 32 * q + lane;
        const bool in = lr < n;
        const int an = in ? an_s[lr] : kDead;
        const uint2 a = in ? ai_s[lr] : make_uint2(0u, 0u);
        const uint32_t all = has(slot(a, 0)) & has(slot(a, 1)) & has(slot(a, 2)) & has(slot(a, 3));
        ok |= (unsigned)((an == 0) | ((an > 0) & (an <= kMaxItems) & (all != 0u))) << q;
        wide |= an >= kWide;
      }
      if (__any_sync(0xffffffffu, wide))  // antecedents the uint16 slots do not hold: rare
        ok = match_rare(ok, bk, an_s, c.af, ante, r0, g, n, w, lane);
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const unsigned hits = __ballot_sync(0xffffffffu, (ok >> q) & 1u);
        if ((ok >> q) & 1u) list[cnt + __popc(hits & below)] = (uint16_t)(g + 32 * q + lane);
        cnt += __popc(hits);
      }
    }
    __syncwarp();

    // fan-out of the window's items, 32 matched rules at a time
    for (int base = 0; base < cnt; base += 32) {
      const int ng = min(32, cnt - base);
      const int lr = list[base + min(lane, ng - 1)];
      const int cn = lane < ng ? cn_s[lr] : 0;
      const uint2 ci = ci_s[lr];
      const float s = score_s[lr];
      if (__any_sync(0xffffffffu, cn >= kWide)) {  // rule by rule: rare
        for (int m = 0; m < ng; ++m) {
          const int cm = __shfl_sync(0xffffffffu, cn, m);
          const uint2 cs = make_uint2(__shfl_sync(0xffffffffu, ci.x, m), __shfl_sync(0xffffffffu, ci.y, m));
          const float sm = __shfl_sync(0xffffffffu, s, m);
          const int lrm = __shfl_sync(0xffffffffu, lr, m);
          if (cm == kWide) {
            const uint32_t* cr = cons + (size_t)(r0 + lrm) * w + w0;
            for (int k = 0; k < wn; ++k)
              if ((__ldg(cr + k) >> lane) & 1u) row[k * kRowStride + lane] += sm;
          } else if (cm > kFar) {
            const uint4 f = c.cf[r0 + lrm];
            const uint32_t ids[kMaxItems] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int k = 0; k < kMaxItems; ++k)
              if (k < cm - kFar && (ids[k] & 31u) == (uint32_t)lane && mine(ids[k]))
                row[((ids[k] >> 5) - w0) * kRowStride + lane] += sm;
          } else {
#pragma unroll
            for (int k = 0; k < kMaxItems; ++k) {
              const uint32_t item = slot(cs, k);
              if (k < cm && (item & 31u) == (uint32_t)lane && mine(item))
                row[((item >> 5) - w0) * kRowStride + lane] += sm;
            }
          }
        }
        continue;
      }
      // the group's items in the window, in rule order, as (item - 32·w0)
      // << 5 | rule: lane t's at [off, off + cw)
      int cw = 0;
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) cw += (k < cn && mine(slot(ci, k))) ? 1 : 0;
      int off = cw;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, off, d);
        if (lane >= d) off += v;
      }
      const int total = __shfl_sync(0xffffffffu, off, 31);
      off -= cw;
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const uint32_t item = slot(ci, k);
        if (k < cn && mine(item)) items[off++] = (item - 32u * w0) << 5 | (uint32_t)lane;
      }
      __syncwarp();
      // queue each item's place for its owner lane i % 32, 32 places at a
      // time: its rank among this round's places of the same owner, after
      // the owner's places of earlier rounds (qn, held by the owner lane)
      int qn = 0;
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int e = e0 + lane;
        const uint32_t owner = e < total ? (items[e] >> 5) & 31u : 32u;
        const unsigned same = __match_any_sync(0xffffffffu, owner);
        const int before = __shfl_sync(0xffffffffu, qn, owner & 31u);
        if (owner < 32u) {
          queue_w[32 * (before + __popc(same & below)) + owner] = (uint8_t)e;
          if ((same & below) == 0u) counts[owner] = __popc(same);
        }
        __syncwarp();
        qn += counts[lane];
        counts[lane] = 0;
        __syncwarp();
      }
      // then each lane adds its queue in order; kBatch reads go out before
      // the writes that depend on them
      const int qmax = __reduce_max_sync(0xffffffffu, qn);
      for (int q0 = 0; q0 < qmax; q0 += kBatch) {
        uint32_t v[kBatch];
        float sv[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          v[b] = items[q0 + b < qn ? queue[32 * (q0 + b)] : 0];
          sv[b] = __shfl_sync(0xffffffffu, s, v[b] & 31u);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (q0 + b < qn) row[(v[b] >> 10) * kRowStride + lane] += sv[b];
      }
      __syncwarp();  // items is rewritten by the next group
    }
  }

  __syncthreads();  // rows complete (and initialised, where R is empty)
  if (!live) return;
  float* o = out + (size_t)(b0 + warp) * (32 * (size_t)w) + 32 * (size_t)w0;
  for (int i = 4 * lane; i < 32 * wn; i += 128) {
    const float* src = row + (i >> 5) * kRowStride + (i & 31);
    *reinterpret_cast<float4*>(o + i) = make_float4(src[0], src[1], src[2], src[3]);
  }
}

template <bool kTiled>
int launch_with(const void* baskets, const void* ante, const void* cons, const void* scores,
                const Compact& c, void* out, int nb, int nr, int w, cudaStream_t stream) {
  const int wt = kTiled ? kWindow : w;
  const long long smem = smem_bytes(wt, kTiled ? 0 : w);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rule_match_kernel<kTiled>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long groups = (nb + kWarps - 1) / kWarps;
  const long long grid = groups * ((w + wt - 1) / wt);
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  rule_match_kernel<kTiled><<<(unsigned)grid, 32 * kWarps, (size_t)smem, stream>>>(
      static_cast<const uint32_t*>(baskets), static_cast<const uint32_t*>(ante),
      static_cast<const uint32_t*>(cons), static_cast<const float*>(scores), c,
      static_cast<float*>(out), nb, nr, w, wt);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device scratch the launch needs for nr rules.
extern "C" long long rule_match_scratch_bytes(int nr) { return scratch_bytes(nr); }

// baskets (nb, w), ante / cons (nr, w) uint32 words; lengths (nr,) int32;
// scores (nr,) float32; out (nb, 32w) float32; scratch of
// rule_match_scratch_bytes(nr) bytes, 8-byte aligned.  Any w with 32·w
// items numbered in an int.  Returns cudaGetLastError().
extern "C" int rule_match_launch(const void* baskets, const void* ante, const void* lengths,
                                 const void* cons, const void* scores, void* out, void* scratch,
                                 int nb, int nr, int w, void* stream) {
  if (nb <= 0) return 0;
  if (w <= 0 || 32LL * w > INT_MAX || nr < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Compact c = carve(scratch, nr);
  if (nr > 0) {
    compact_rules_kernel<<<(unsigned)((nr + 7LL) / 8), 256, 0, s>>>(
        static_cast<const uint32_t*>(ante), static_cast<const int32_t*>(lengths),
        static_cast<const uint32_t*>(cons), c, nr, w);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (w <= kWindow) return launch_with<false>(baskets, ante, cons, scores, c, out, nb, nr, w, s);
  return launch_with<true>(baskets, ante, cons, scores, c, out, nb, nr, w, s);
}
