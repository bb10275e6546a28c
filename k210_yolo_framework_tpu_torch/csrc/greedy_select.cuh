// Per-row greedy NMS selection for Hopper (sm_90a), shared by the fused
// decode+NMS head (yolo_head.cu) and NMS alone (nms.cu).
//
// Counterpart of greedy_select_loop in k210_yolo_framework_tpu/ops/nms_pallas.py;
// its plain PyTorch version is greedy_select_loop in
// k210_yolo_framework_tpu_torch/ops/nms_pallas.py.  One thread block runs one
// row (one (image, class) pair) whose N scores and N boxes sit in shared
// memory.  Each step:
//   * the block argmax of the row (NaN above every number, then the larger
//     value, then the lower index), computed by the previous step's pass;
//   * the row leaves its loop once that max is below the threshold (or NaN):
//     winners come out in non-increasing order and the caller masks slots
//     below the threshold, so later steps could keep nothing;
//   * the winner's box read from shared memory as max(coord, -1e9) (the TPU
//     kernel's masked-max pick), and one pass of IoU against every candidate
//     that suppresses the winner and every box with IoU > iou_thresh, and
//     computes each thread's argmax for the next step.
// Every arithmetic step follows the plain version in the same order; built
// with -fmad=false the two agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace greedy {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e9f;

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

// Order of the greedy argmax: a NaN beats every number (the row max is then
// NaN and the row selects nothing), then the larger value, then the lower
// index (the first index holding the max).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (is_nan(v)) return !is_nan(bv) || i < bi;
  if (is_nan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

// Block-wide argmax of each thread's (v, i); every thread gets the result.
// red_v / red_i hold kWarps + 1 entries in shared memory.
__device__ __forceinline__ void block_argmax(float& v, int& i,
                                             float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    // slot kWarps holds the result; it is rewritten only after the next
    // call's first barrier, which every thread reaches after reading it
    if (lane == 0) { red_v[kWarps] = v; red_i[kWarps] = i; }
  }
  __syncthreads();
  v = red_v[kWarps];
  i = red_i[kWarps];
}

// The greedy loop of one row.  s_score and the four box rows hold the row's
// n candidates in shared memory (s_score is overwritten); (best_v, best_i)
// is the block argmax of s_score, already reduced.  Writes winner k to
// os[k] and ob[4k .. 4k+3] (y0, x0, y1, x1) for k < max_out; slots after the
// last winner hold -1e9 and zero boxes.
__device__ __forceinline__ void select_row(
    float* s_score, const float* s_y0, const float* s_x0, const float* s_y1,
    const float* s_x1, int n, int max_out, float iou_thresh,
    float score_thresh, float best_v, int best_i, float* red_v, int* red_i,
    float* os, float* ob) {
  int k = 0;
  for (; k < max_out; ++k) {
    const float m = best_v;
    const int sel = best_i;
    if (!(m >= score_thresh)) break;  // also ends a row whose max is NaN
    // the TPU kernel picks the winner's box by a max over a mask that is
    // -1e9 elsewhere; keep that floor
    const float sy0 = nan_max(s_y0[sel], kNeg);
    const float sx0 = nan_max(s_x0[sel], kNeg);
    const float sy1 = nan_max(s_y1[sel], kNeg);
    const float sx1 = nan_max(s_x1[sel], kNeg);
    const float s_area = nan_max(sy1 - sy0, 0.0f) * nan_max(sx1 - sx0, 0.0f);
    if (threadIdx.x == 0) {
      os[k] = m;
      ob[4 * k + 0] = sy0;
      ob[4 * k + 1] = sx0;
      ob[4 * k + 2] = sy1;
      ob[4 * k + 3] = sx1;
    }
    best_v = -INFINITY;
    best_i = INT_MAX;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float y0 = s_y0[j], x0 = s_x0[j], y1 = s_y1[j], x1 = s_x1[j];
      const float iy = nan_max(nan_min(sy1, y1) - nan_max(sy0, y0), 0.0f);
      const float ix = nan_max(nan_min(sx1, x1) - nan_max(sx0, x0), 0.0f);
      const float inter = iy * ix;
      const float area = nan_max(y1 - y0, 0.0f) * nan_max(x1 - x0, 0.0f);
      const float uni = s_area + area - inter;
      const float iou = uni > 0.0f ? inter / uni : 0.0f;
      float s = s_score[j];
      if (iou > iou_thresh || j == sel) {
        s = kNeg;
        s_score[j] = s;
      }
      if (better(s, j, best_v, best_i)) { best_v = s; best_i = j; }
    }
    block_argmax(best_v, best_i, red_v, red_i);
  }
  for (int kk = k + threadIdx.x; kk < max_out; kk += kThreads) {
    os[kk] = kNeg;
    ob[4 * kk + 0] = 0.0f;
    ob[4 * kk + 1] = 0.0f;
    ob[4 * kk + 2] = 0.0f;
    ob[4 * kk + 3] = 0.0f;
  }
}

}  // namespace greedy
