// Per-row greedy NMS in score order for Hopper (sm_90a): the selection of
// the fused head's global path (yolo_head.cu), where a row's live list is
// too long for the step loop of greedy_select.cuh.
//
// Why it gives the step loop's winners: the loop takes, at each step, the
// best candidate not yet suppressed (the larger score, then the lower
// index), and a suppression is never undone.  Where the threshold is above
// kNeg, a suppressed candidate (score kNeg) can never be taken again, so
// the loop is the same as one visit of the row's candidates at or above
// the threshold in the order (score descending, index ascending), keeping
// each one that no winner kept so far suppresses, up to max_out winners.
// That holds for any pairwise test, so the scan uses the loop's own:
// iou_above of the candidate (its decoded box and area) against the
// winner's box floored at kNeg (and the area of the floored box).  A NaN
// score anywhere among the row's N candidates makes the row select nothing,
// as in the loop.  At a threshold at or below kNeg a suppressed candidate
// stays selectable at kNeg and the two differ: the wrapper keeps the step
// loop there.
//
// What bounds it: the order, not the tests.  A row of the eval cell (B=32,
// N=22,743, threshold 0.01) has ~9,700 live candidates; the step loop
// tested them all again at each of its 100 steps, in one warp, a chain of
// dependent global loads.  Here each candidate is tested once, against the
// <= max_out winners kept before it, and only as deep into the order as
// the row needs.  One block runs one row, in rounds:
//   * a block-wide radix select (8-bit digits from the top, histograms in
//     shared memory, peers of a digit counted once a warp by
//     __match_any_sync) finds a key `lo` such that the keys in [lo, bound)
//     number at most kCap (and at least kCap / 2 where the row has more);
//     bound is the previous round's lo.  A row of at most kCap keys left
//     skips it;
//   * those keys are gathered into shared memory and sorted (bitonic,
//     descending);
//   * the scan takes them kThreads at a time: every thread tests its
//     candidate against the winners kept before the chunk, then warp 0
//     resolves the chunk's survivors in tiles of 32, in order: each lane
//     tests its candidate against the winners the chunk added so far, and
//     against the tile's earlier survivors (a 32x32 conflict mask from one
//     IoU a pair), and one pass over the mask's bits keeps those that no
//     kept one conflicts with.
// The list stays in global scratch and only kCap keys sit in shared
// memory, so any N fits.  Every arithmetic step is the loop's, built with
// -fmad=false; the two agree bit for bit.
//
// A key is 64 bits: the score's bits made order-preserving (zero taken as
// +0), then the candidate index's complement, so that a larger key is the
// better candidate and keys are unique.  The key gives back the score bits
// (a -0 score comes back as +0; the head's scores are products of
// non-negative factors and are never -0).  A row's list is laid out in
// segments of kSeg candidates (one decode block each): segment s holds its
// count (and kNanBit where one of its scores is NaN) in info[s] and its
// keys, in any order, at keys[s * kSeg ...].

#pragma once

#include <cuda_runtime.h>

#include "greedy_select.cuh"

namespace ordered {

using greedy::box_area;
using greedy::Entry;
using greedy::iou_above;
using greedy::kFull;
using greedy::kNeg;
using greedy::nan_max;

typedef unsigned long long Key;

constexpr int kSeg = 256;           // candidates a segment (a decode block)
constexpr int kThreads = 256;       // threads of a select block
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 2048;          // keys a round holds in shared memory
constexpr int kBins = 256;          // an 8-bit digit's histogram
constexpr int kNanBit = 1 << 30;    // in a segment's info: a NaN score

__device__ __forceinline__ Key make_key(float s, int j) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)o << 32) | (0xffffffffu - (unsigned)j);
}

__device__ __forceinline__ float key_score(Key k) {
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ int key_index(Key k) {
  return (int)(0xffffffffu - (unsigned)k);
}

// Dynamic shared memory of a select block: the round's keys, the winners'
// boxes, the chunk's boxes, the winners' and the chunk's areas, and the
// row's segment counts.
__host__ __device__ inline size_t smem_bytes(int n_seg, int max_out) {
  return (size_t)kCap * sizeof(Key)
         + ((size_t)max_out + kThreads) * (sizeof(float4) + sizeof(float))
         + (size_t)n_seg * sizeof(int);
}

// Bytes of one launch's scratch: the image's boxes and areas ([B, N]) and
// each row's segment infos and keys ([B * C, n_seg] and [B * C, n_seg *
// kSeg]), each array 16-byte aligned.
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

struct Scratch {
  float4* boxes;
  float* areas;
  int* info;
  Key* keys;
};

__host__ __device__ inline size_t scratch_bytes(int batch, int n,
                                                int classes) {
  const size_t n_seg = ((size_t)n + kSeg - 1) / kSeg;
  const size_t rows = (size_t)batch * classes;
  return align16((size_t)batch * n * sizeof(float4))
         + align16((size_t)batch * n * sizeof(float))
         + align16(rows * n_seg * sizeof(int))
         + rows * n_seg * kSeg * sizeof(Key);
}

__host__ __device__ inline Scratch scratch_at(void* base, int batch, int n,
                                              int classes) {
  const size_t n_seg = ((size_t)n + kSeg - 1) / kSeg;
  const size_t rows = (size_t)batch * classes;
  char* p = static_cast<char*>(base);
  Scratch s;
  s.boxes = reinterpret_cast<float4*>(p);
  p += align16((size_t)batch * n * sizeof(float4));
  s.areas = reinterpret_cast<float*>(p);
  p += align16((size_t)batch * n * sizeof(float));
  s.info = reinterpret_cast<int*>(p);
  p += align16(rows * n_seg * sizeof(int));
  s.keys = reinterpret_cast<Key*>(p);
  return s;
}

// Appends one segment's keys of one row, called by every thread of a
// kSeg-thread decode block once a class, in the same order by all: `keep`
// where the thread's candidate j is at or above the threshold (score s),
// `nan` where its score is NaN.  `counts` is the block's [2][kSeg / 32]
// shared array, used in turn by successive calls (`parity`).
__device__ __forceinline__ void append_segment(Key* keys, int* info,
                                               bool keep, bool nan, float s,
                                               int j, int* counts,
                                               int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, keep);
  int* cnt = counts + parity * (kSeg / 32);
  if (lane == 0) cnt[warp] = __popc(ballot);
  // the barrier orders this call's counts before their reads; every thread
  // read the other parity's, the previous call's, before reaching it
  const int any_nan = __syncthreads_or(nan);
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kSeg / 32; ++w) {
    const int v = cnt[w];
    off += w < warp ? v : 0;
    total += v;
  }
  if (keep)
    keys[off + __popc(ballot & ((1u << lane) - 1u))] = make_key(s, j);
  if (threadIdx.x == 0) *info = total | (any_nan ? kNanBit : 0);
}

// The per-block state of a row's selection in shared memory.
struct Shared {
  Key* keys;        // [kCap] the round's keys
  float4* wbox;     // [max_out] winners' floored boxes
  float4* cbox;     // [kThreads] the chunk's boxes
  float* warea;     // [max_out] their areas
  float* carea;     // [kThreads]
  int* seg_cnt;     // [n_seg]
};

// Calls f(key) for every key of the row's list (all threads, uniformly).
// kUnroll segments' loads come before their calls, so that their
// latencies overlap.
template <typename F>
__device__ __forceinline__ void for_each_key(const Key* row_keys,
                                             const int* seg_cnt, int n_seg,
                                             F f) {
  constexpr int kUnroll = 4;
  for (int s0 = 0; s0 < n_seg; s0 += kUnroll) {
    bool has[kUnroll];
    Key k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      has[u] = s < n_seg && (int)threadIdx.x < seg_cnt[s];
      k[u] = has[u] ? row_keys[(size_t)s * kSeg + threadIdx.x] : (Key)0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(has[u], k[u]);
  }
}

// A key `lo` such that kCap / 2 to kCap of the row's keys lie in [lo,
// bound), for a row with more than kCap keys below bound.
__device__ Key radix_lo(const Key* row_keys, const int* seg_cnt, int n_seg,
                        Key bound, int* hist, int* s_pick) {
  const int lane = threadIdx.x & 31;
  Key prefix = 0, pmask = 0;
  int need = kCap, taken = 0;
  for (int shift = 56;; shift -= 8) {
    for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    for_each_key(row_keys, seg_cnt, n_seg, [&](bool has, Key k) {
      const bool in = has && k < bound && (k & pmask) == prefix;
      const int digit = (int)(k >> shift) & (kBins - 1);
      // lanes of one digit add once; a lane out of the count is its own peer
      const unsigned peers =
          __match_any_sync(kFull, in ? digit : kBins + lane);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l sums bins 255 - 8l down to 248 - 8l; a scan over the lanes
      // gives the count above each lane's bins
      int part = 0;
#pragma unroll
      for (int i = 0; i < kBins / 32; ++i)
        part += hist[kBins - 1 - 8 * lane - i];
      int incl = part;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      int above = incl - part;
      // the bin where the count from the top first exceeds `need`
      int pick = -1, pick_above = 0;
      if (above <= need && incl > need) {
        for (int i = 0; i < kBins / 32; ++i) {
          const int bin = kBins - 1 - 8 * lane - i;
          if (above + hist[bin] > need) {
            pick = bin;
            pick_above = above;
            break;
          }
          above += hist[bin];
        }
      }
      const unsigned who = __ballot_sync(kFull, pick >= 0);
      if (who && lane == __ffs(who) - 1) {
        s_pick[0] = pick;
        s_pick[1] = pick_above;
      }
      if (!who && lane == 31) {   // every key of the prefix fits
        s_pick[0] = -1;
        s_pick[1] = incl;
      }
    }
    __syncthreads();
    const int bin = s_pick[0], above = s_pick[1];
    __syncthreads();   // s_pick and hist are rewritten by the next pass
    if (bin < 0) return prefix;
    need -= above;
    taken += above;
    if (need == 0 || taken >= kCap / 2 || shift == 0)
      return (prefix | ((Key)bin << shift)) + ((Key)1 << shift);
    prefix |= (Key)bin << shift;
    pmask |= (Key)(kBins - 1) << shift;
  }
}

// Sorts keys[0 .. p) descending, p a power of two (bitonic network).
__device__ void sort_desc(Key* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kThreads) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const Key a = keys[i], b = keys[i + stride];
        if ((a < b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The winner's box as the loop takes it: each coordinate floored at kNeg.
__device__ __forceinline__ float4 floored(const float4& b) {
  return make_float4(nan_max(b.x, kNeg), nan_max(b.y, kNeg),
                     nan_max(b.z, kNeg), nan_max(b.w, kNeg));
}

__device__ __forceinline__ bool suppressed(const Entry& e, const float4* wbox,
                                           const float* warea, int from,
                                           int to, float t) {
  for (int w = from; w < to; ++w)
    if (iou_above<false>(e, wbox[w], warea[w], t)) return true;
  return false;
}

// One row in score order, run by a whole kThreads block.  row_keys and
// info: the row's list (n_seg segments); boxes and areas: its image's N
// decoded boxes and areas.  Writes winner k to os[k] and ob[4k .. 4k+3]
// for k < max_out, kNeg and zero boxes after the last; adds the positions
// the scan went through (its depth) to *tested where given.
__device__ void select_row(const Key* row_keys, const int* info, int n_seg,
                           const float4* boxes, const float* areas,
                           int max_out, float iou_thresh, float* os,
                           float* ob, unsigned long long* tested,
                           const Shared& sh) {
  __shared__ int s_total, s_count, s_k, s_done;
  __shared__ int s_pick[2];
  __shared__ int hist[kBins];
  __shared__ unsigned surv[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  if (threadIdx.x == 0) { s_total = 0; s_k = 0; s_done = 0; }
  __syncthreads();
  int part = 0;
  bool nan = false;
  for (int s = threadIdx.x; s < n_seg; s += kThreads) {
    const int v = info[s];
    nan |= (v & kNanBit) != 0;
    sh.seg_cnt[s] = v & ~kNanBit;
    part += v & ~kNanBit;
  }
  if (part) atomicAdd(&s_total, part);
  const bool row_nan = __syncthreads_or(nan);
  int remaining = row_nan ? 0 : s_total;

  long long depth = 0;   // thread 0's count
  Key bound = ~(Key)0;
  while (remaining > 0 && !s_done) {
    const Key lo = remaining <= kCap
        ? 0 : radix_lo(row_keys, sh.seg_cnt, n_seg, bound, hist, s_pick);
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    for_each_key(row_keys, sh.seg_cnt, n_seg, [&](bool has, Key k) {
      const bool take = has && k >= lo && k < bound;
      const unsigned ballot = __ballot_sync(kFull, take);
      int base = 0;
      if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
      base = __shfl_sync(kFull, base, 0);
      if (take) sh.keys[base + __popc(ballot & below)] = k;
    });
    __syncthreads();
    const int m = s_count;
    int p = 32;
    while (p < m) p <<= 1;
    for (int i = m + threadIdx.x; i < p; i += kThreads) sh.keys[i] = 0;
    __syncthreads();
    sort_desc(sh.keys, p);

    for (int base = 0; base < m; base += kThreads) {
      // every thread: its candidate against the winners before the chunk
      const int k0 = s_k;
      const int i = base + threadIdx.x;
      bool alive = i < m;
      if (alive) {
        const int j = key_index(sh.keys[i]);
        Entry e;
        e.box = boxes[j];
        e.area = areas[j];
        alive = !suppressed(e, sh.wbox, sh.warea, 0, k0, iou_thresh);
        sh.cbox[threadIdx.x] = e.box;
        sh.carea[threadIdx.x] = e.area;
      }
      const unsigned ballot = __ballot_sync(kFull, alive);
      if (lane == 0) surv[warp] = ballot;
      __syncthreads();
      if (warp == 0) {
        // warp 0: the chunk's survivors in order, a tile of 32 at a time
        int k = k0, used = min(kThreads, m - base);
        for (int tile = 0; tile < kWarps && base + 32 * tile < m; ++tile) {
          unsigned mask = surv[tile];
          if (!mask) continue;
          const int c = 32 * tile + lane;
          Entry e;
          e.box = sh.cbox[c];
          e.area = sh.carea[c];
          bool live = (mask >> lane) & 1u;
          if (live && suppressed(e, sh.wbox, sh.warea, k0, k, iou_thresh))
            live = false;
          mask = __ballot_sync(kFull, live);
          if (!mask) continue;
          const float4 f = floored(e.box);
          const float fa = box_area(f.x, f.y, f.z, f.w);
          // bit q: survivor q, earlier in the tile, suppresses this lane's
          unsigned conflict = 0;
          for (unsigned rest = mask; rest; rest &= rest - 1) {
            const int q = __ffs(rest) - 1;
            const float4 wq = make_float4(__shfl_sync(kFull, f.x, q),
                                          __shfl_sync(kFull, f.y, q),
                                          __shfl_sync(kFull, f.z, q),
                                          __shfl_sync(kFull, f.w, q));
            const float aq = __shfl_sync(kFull, fa, q);
            if (live && q < lane && iou_above<false>(e, wq, aq, iou_thresh))
              conflict |= 1u << q;
          }
          unsigned sel = 0;
          int last = -1;
          for (unsigned rest = mask; rest; rest &= rest - 1) {
            const int q = __ffs(rest) - 1;
            if (!(__shfl_sync(kFull, conflict, q) & sel)) {
              sel |= 1u << q;
              last = q;
              if (k + __popc(sel) == max_out) break;
            }
          }
          if ((sel >> lane) & 1u) {
            const int at = k + __popc(sel & below);
            sh.wbox[at] = f;
            sh.warea[at] = fa;
            os[at] = key_score(sh.keys[base + c]);
            reinterpret_cast<float4*>(ob)[at] = f;
          }
          k += __popc(sel);
          __syncwarp();   // the new winners before the next tile's reads
          if (k == max_out) {
            used = 32 * tile + last + 1;
            break;
          }
        }
        if (lane == 0) {
          s_k = k;
          s_done = k == max_out;
          depth += used;
        }
      }
      __syncthreads();
      if (s_done) break;
    }
    remaining -= m;
    bound = lo;
  }
  const int k = s_k;
  for (int kk = k + threadIdx.x; kk < max_out; kk += kThreads) {
    os[kk] = kNeg;
    reinterpret_cast<float4*>(ob)[kk] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (tested && threadIdx.x == 0 && depth)
    atomicAdd(tested, (unsigned long long)depth);
}

}  // namespace ordered
