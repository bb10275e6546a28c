// Per-row greedy NMS selection for Hopper (sm_90a), shared by the fused
// decode+NMS head (yolo_head.cu) and NMS alone (nms.cu).
//
// Counterpart of greedy_select_loop in k210_yolo_framework_tpu/ops/nms_pallas.py;
// its plain PyTorch version is greedy_select_loop in
// k210_yolo_framework_tpu_torch/ops/nms_pallas.py.  A row is one (image,
// class) pair; one warp runs it.  A block holds G rows of one image (one
// warp each) and the image's N boxes, loaded or decoded once for all G.
//
// What bounds the loop: each row is a chain of up to max_out dependent
// steps, each a pass over the candidates the step has to test (the live
// ones).  At B=128, C=20 every row of the batch is resident at once (about
// 20 warps an SM), and the passes are bound by instruction throughput:
// each test spends its reads, the IoU, the division test and the compaction.
// With few rows an SM (B=32) the chain's latency bounds them.  The design
// keeps the chain short and each test cheap:
//   * no block barrier inside a row's loop: the argmax is 5 rounds of
//     __shfl_xor_sync on (value, position) inside the warp;
//   * each row keeps its live candidates (those that can still win) as a
//     list compacted in shared memory, in index order.  The first pass
//     builds it from the row's N scores; each step's IoU pass rewrites it
//     in place (__ballot_sync and __popc give each lane its destination,
//     never ahead of the chunk being read) and computes each lane's argmax
//     for the next step.  So a step tests only the list, not all N;
//   * a pass reads kUnroll chunks before it tests any, so their shared-
//     memory latencies overlap;
//   * the IoU's division runs only where the boxes intersect and the
//     quotient can exceed the threshold (an fmaf gives the sign of
//     inter - t * uni); a block whose boxes are all finite and within
//     +-kTame tests them without NaN handling (same answers as the
//     NaN-handling IoU, which alone took 14-27% longer on dense rows of an
//     H100: PERF.md, greedy_times.py);
//   * each row leaves its loop on its own, at max_out winners or once its
//     best score is below the threshold.
// A block has at least kMinWarps warps, so the load (or decode) before the
// loops is spread over 256 threads even where G is small.

// A candidate leaves the list when its score after this step's suppression
// (kNeg) is below the threshold: no later step can select it.  Where the
// threshold is at or below kNeg, suppression can raise a score to kNeg
// >= threshold, so nothing leaves and the list is the whole row, as in the
// plain loop.  A NaN anywhere in a row's scores makes the row select
// nothing (the plain max is NaN); the first pass tests for it before
// anything leaves.  Since the list keeps index order, a position stands for
// its index in the argmax's tie order (NaN first, then the larger value,
// then the lower index).
//
// Three layouts of a row:
//   * SharedBoxes (G > 1, shared memory, footprint smem_bytes): the image's
//     boxes and areas once per block, and per row a list of (score,
//     16-bit candidate index);
//   * OwnBoxes (G == 1, shared memory): the row's scores and boxes
//     compacted together in place, 5 floats a candidate; the area is
//     computed where it is tested.  It fits the most candidates a block's
//     shared memory can hold (11,622 on an H100);
//   * GlobalBoxes (any G, global memory): where neither shared layout
//     fits.  SharedBoxes' layout with 32-bit indices, in a scratch slab of
//     the block's own (scratch_floats): the boxes and areas once (8 bytes
//     a candidate fewer than OwnBoxes' 20 per row at G > 1), each row's
//     list beside them.  A warp reads what other lanes of it wrote only
//     after a __syncwarp, which orders global memory as it orders shared
//     memory; the rewrite of the list in place keeps its order as above.
// Every arithmetic step follows the plain version in the same order; built
// with -fmad=false the two agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace greedy {

constexpr int kMaxRows = 32;            // warps (rows) per block at most
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;
constexpr int kMinWarps = 8;            // warps a block loads with at least
constexpr int kUnroll = 2;              // chunks of 32 candidates a round
// boxes within +-kTame: no difference, product or sum of the IoU overflows
constexpr float kTame = 1e18f;

// Where a block keeps its rows: the three layouts above.
enum Layout { kOwn, kShared, kGlobal };

// The kernel of a launch, given its instance for each layout: the global
// path where a scratch slab is given, else the shared layout of `rows`.
template <typename KernelFn>
KernelFn pick_kernel(int rows, bool global, KernelFn own, KernelFn shared,
                     KernelFn in_global) {
  if (global) return in_global;
  return rows > 1 ? shared : own;
}

// Dynamic shared memory of a block of g rows of n candidates.
__host__ __device__ inline size_t smem_bytes(int n, int g) {
  if (g == 1) return (size_t)5 * n * sizeof(float);
  return (size_t)n * (5 * sizeof(float)
                      + g * (sizeof(float) + sizeof(unsigned short)));
}

// GlobalBoxes: the stride of a block's arrays, n rounded up to a multiple
// of 4 so that every slab and its float4 boxes stay 16-byte aligned.
__host__ __device__ inline size_t global_stride(int n) {
  return ((size_t)n + 3) & ~(size_t)3;
}

// GlobalBoxes: floats of one block's scratch slab holding `per_candidate`
// floats a candidate for the whole block (5: boxes and areas; 1: areas
// only, where the boxes are read from the input) and a (score, index)
// list per row.
__host__ __device__ inline size_t scratch_floats(int n, int g,
                                                 int per_candidate) {
  return global_stride(n) * (per_candidate + 2 * (size_t)g);
}

// NaN-propagating max/min, as jnp.maximum / torch.maximum (fmaxf drops NaN).
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ float nan_max(float a, float b) {
  if (is_nan(a) || is_nan(b)) return a + b;
  return a > b ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (is_nan(a) || is_nan(b)) return a + b;
  return a < b ? a : b;
}

__device__ __forceinline__ bool tame_box(float y0, float x0, float y1,
                                         float x1) {
  // false for NaN and inf
  return fabsf(y0) <= kTame && fabsf(x0) <= kTame && fabsf(y1) <= kTame &&
         fabsf(x1) <= kTame;
}

__device__ __forceinline__ float box_area(float y0, float x0, float y1,
                                          float x1) {
  return nan_max(y1 - y0, 0.0f) * nan_max(x1 - x0, 0.0f);
}

// Order of the greedy argmax: a NaN beats every number, then the larger
// value, then the lower index (or list position).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (is_nan(v)) return !is_nan(bv) || i < bi;
  if (is_nan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

// Warp-wide argmax of each lane's (v, i); every lane gets the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

struct Entry {
  float s;
  float4 box;   // y0, x0, y1, x1
  float area;
  int j;
};

// G > 1 (and GlobalBoxes): boxes and areas of the image, indexed by
// candidate; the row's list holds (score, candidate index) at each
// position.  Before the first pass score[j] holds the row's score of
// candidate j.
template <typename Index, bool kInGlobal>
struct BoxList {
  static constexpr bool kGlobal = kInGlobal;
  const float4* boxes;
  const float* area;
  float* score;
  Index* idx;

  __device__ Entry staged(int j) const {
    Entry e;
    e.s = score[j];
    e.j = j;
    return e;
  }
  __device__ Entry load(int p) const {
    Entry e;
    e.j = idx[p];
    e.s = score[p];
    e.box = boxes[e.j];
    e.area = area[e.j];
    return e;
  }
  __device__ void store(int p, const Entry& e) const {
    score[p] = e.s;
    idx[p] = (Index)e.j;
  }
  __device__ float4 box(int p) const { return boxes[idx[p]]; }
};

using SharedBoxes = BoxList<unsigned short, false>;
using GlobalBoxes = BoxList<int, true>;

// G == 1: the row's score and box of each list position, compacted
// together; before the first pass position j holds candidate j.
struct OwnBoxes {
  static constexpr bool kGlobal = false;
  float4* boxes;
  float* score;

  __device__ Entry load(int p) const {
    Entry e;
    e.s = score[p];
    e.box = boxes[p];
    e.area = box_area(e.box.x, e.box.y, e.box.z, e.box.w);
    e.j = p;
    return e;
  }
  __device__ Entry staged(int j) const { return load(j); }
  __device__ void store(int p, const Entry& e) const {
    score[p] = e.s;
    boxes[p] = e.box;
  }
  __device__ float4 box(int p) const { return boxes[p]; }
};

// Whether the plain version's IoU of candidate e with the winner's box
// `w` of area w_area, RN(inter / uni), exceeds t.
template <bool kTame>
__device__ __forceinline__ bool iou_above(const Entry& e, const float4& w,
                                          float w_area, float t) {
  float iy, ix;
  if (kTame) {
    // no NaN or inf can arise: fminf / fmaxf agree with nan_min / nan_max
    // (a zero's sign never reaches the result)
    iy = fmaxf(fminf(w.z, e.box.z) - fmaxf(w.x, e.box.x), 0.0f);
    ix = fmaxf(fminf(w.w, e.box.w) - fmaxf(w.y, e.box.y), 0.0f);
  } else {
    iy = nan_max(nan_min(w.z, e.box.z) - nan_max(w.x, e.box.x), 0.0f);
    ix = nan_max(nan_min(w.w, e.box.w) - nan_max(w.y, e.box.y), 0.0f);
  }
  const float inter = iy * ix;
  const float uni = w_area + e.area - inter;
  // the plain IoU is inter / uni where uni > 0, else 0; inter is +0,
  // positive, inf or NaN, and +0 / uni is +0
  if (!(uni > 0.0f && inter != 0.0f)) return 0.0f > t;
  // fmaf rounds inter - t * uni once, and a negative result means that
  // inter - t * uni, and so inter / uni - t, is negative: the rounded
  // quotient cannot exceed t, and the division is left out
  return !(fmaf(-t, uni, inter) < 0.0f) && inter / uni > t;
}

// The greedy loop of one row, run by one whole warp.  The row's n scores
// (and, for OwnBoxes, boxes) are staged in shared memory; kTame says that
// every box coordinate of the image is finite and within +-kTame, so no IoU
// can meet a NaN or an inf (tame_box of every box).  Writes winner k to
// os[k] and ob[4k .. 4k+3] (y0, x0, y1, x1) for k < max_out; slots after the
// last winner hold kNeg and zero boxes.
template <bool kTame, typename Row>
__device__ void select_row_as(const Row& row, int n, int max_out,
                              float iou_thresh, float score_thresh,
                              float* os, float* ob) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // a suppressed candidate gets kNeg: where that clears the threshold, no
  // candidate may leave the list (see the note at the top)
  const bool keep_all = kNeg >= score_thresh;

  // first pass: the NaN test over the whole row, the list, the argmax
  bool row_nan = false;
  float best_v = -INFINITY;
  int best_p = INT_MAX;
  int n_live = 0;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    bool keep = false;
    Entry e;
    if (j < n) {
      e = row.staged(j);
      row_nan |= is_nan(e.s);
      keep = keep_all || e.s >= score_thresh;
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    __syncwarp();   // OwnBoxes: the box reads do not feed the ballot
    if (keep) {
      const int dest = n_live + __popc(ballot & below);
      row.store(dest, e);
      if (better(e.s, dest, best_v, best_p)) { best_v = e.s; best_p = dest; }
    }
    n_live += __popc(ballot);
  }
  row_nan = __any_sync(kFull, row_nan);
  warp_argmax(best_v, best_p);
  __syncwarp();

  int k = 0;
  if (!row_nan) {
    for (; k < max_out; ++k) {
      if (n_live == 0 || !(best_v >= score_thresh)) break;
      const int sel = best_p;
      // the TPU kernel picks the winner's box by a max over a mask that is
      // -1e9 elsewhere; keep that floor
      float4 w = row.box(sel);
      w = make_float4(nan_max(w.x, kNeg), nan_max(w.y, kNeg),
                      nan_max(w.z, kNeg), nan_max(w.w, kNeg));
      const float w_area = box_area(w.x, w.y, w.z, w.w);
      if (lane == 0) {
        os[k] = best_v;
        reinterpret_cast<float4*>(ob)[k] = w;
      }
      best_v = -INFINITY;
      best_p = INT_MAX;
      int out = 0;
      // kUnroll chunks a round: the round's reads all come before its
      // first write, a write lands at or before its own chunk's reads
      // (dest <= p), and every read of a chunk precedes that chunk's ballot
      for (int base = 0; base < n_live; base += 32 * kUnroll) {
        // all the round's reads first, so their latencies overlap; a lane
        // past the list reads the last entry and keeps nothing
        Entry e[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = base + 32 * u + lane;
          e[u] = row.load(p < n_live ? p : n_live - 1);
        }
        bool keep[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = base + 32 * u + lane;
          // an entry of the list is at or above the threshold (or keep_all):
          // it stays unless suppressed
          const bool hit =
              iou_above<kTame>(e[u], w, w_area, iou_thresh) || p == sel;
          if (hit) e[u].s = kNeg;
          keep[u] = p < n_live && (keep_all || !hit);
        }
        // global memory: every lane's reads of the round before any write
        if (Row::kGlobal) __syncwarp();
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned ballot = __ballot_sync(kFull, keep[u]);
          if (keep[u]) {
            const int dest = out + __popc(ballot & below);
            row.store(dest, e[u]);
            // no NaN here, and a lane's positions only grow: the first of
            // equal scores stays
            if (e[u].s > best_v || best_p == INT_MAX) {
              best_v = e[u].s;
              best_p = dest;
            }
          }
          out += __popc(ballot);
        }
      }
      n_live = out;
      warp_argmax(best_v, best_p);
      __syncwarp();
    }
  }
  for (int kk = k + lane; kk < max_out; kk += 32) {
    os[kk] = kNeg;
    reinterpret_cast<float4*>(ob)[kk] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// select_row_as with the IoU without NaN handling where `tame` (every box of
// the image passes tame_box).
template <typename Row>
__device__ void select_row(const Row& row, int n, bool tame, int max_out,
                           float iou_thresh, float score_thresh, float* os,
                           float* ob) {
  if (tame)
    select_row_as<true>(row, n, max_out, iou_thresh, score_thresh, os, ob);
  else
    select_row_as<false>(row, n, max_out, iou_thresh, score_thresh, os, ob);
}

}  // namespace greedy
