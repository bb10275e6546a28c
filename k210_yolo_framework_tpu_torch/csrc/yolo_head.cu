// Fused YOLO head for Hopper (sm_90a): decode + letterbox inverse + per-class
// greedy NMS, one thread block per (class, image) row.
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/yolo_head_pallas.py:_kernel
// together with its selection loop, k210_yolo_framework_tpu/ops/nms_pallas.py:
// greedy_select_loop.  The plain PyTorch version of the same function is
// fused_decode_nms_reference in k210_yolo_framework_tpu_torch/ops/yolo_head_pallas.py;
// every arithmetic step below follows it in the same order, and the build uses
// -fmad=false (no mul+add contraction) and no fast math, so the two agree
// bit for bit wherever the transcendental functions do.
//
// What bounds it: not bytes.  The input is [B, N, 5+C] fp32 logits (about
// 13 MB at B=128, N=1050, C=20); each image's slice is re-read by its C blocks,
// from L2.  The bound is the sequential chain of up to max_out block-wide
// argmax reductions of each row.  The design keeps that chain short and local:
//   * the row's N scores and N boxes (5*N floats: 21 KB at N=1050, 88 KB at
//     N=4410) live in shared memory for the whole loop, sized from N;
//   * each step is one block argmax (NaN-propagating, lowest index on ties),
//     a read of the winner's box straight from shared memory, and one pass of
//     IoU + suppression that also computes the next step's per-thread argmax;
//   * each block leaves its loop on its own once its best score is below the
//     threshold, so sparse rows cost a step or two.
//
// Inputs : preds [B, N, E] fp32 (E = 5 + C: tx ty tw th conf cls...),
//          geom  [8, N] fp32 (gx, gy, 1/gw, 1/gh, anchor_w, anchor_h, 1, 0),
//          lbox  [B, 8] fp32 (off_y, off_x, sy, sx, img_h, img_w, 0, 0).
// Outputs: out_scores [B, C, M] and out_boxes [B, C, M, 4] winner buffers;
//          slot k holds winner k, unfilled slots hold -1e9 and zero boxes.
//          The caller masks slots below the threshold.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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

__global__ void __launch_bounds__(kThreads)
yolo_head_kernel(const float* __restrict__ preds,
                 const float* __restrict__ geom,
                 const float* __restrict__ lbox,
                 float* __restrict__ out_scores,
                 float* __restrict__ out_boxes,
                 int n, int classes, int max_out,
                 float iou_thresh, float score_thresh, int class_softmax) {
  extern __shared__ float smem[];
  float* s_score = smem;
  float* s_y0 = smem + n;
  float* s_x0 = smem + 2 * n;
  float* s_y1 = smem + 3 * n;
  float* s_x1 = smem + 4 * n;
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int e = 5 + classes;
  const float* p_img = preds + (size_t)b * n * e;
  const float* lb = lbox + (size_t)b * 8;
  const float off_y = lb[0], off_x = lb[1];
  const float sy = lb[2], sx = lb[3];
  const float ih = lb[4], iw = lb[5];

  // decode every candidate of image b, score it for class c
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* p = p_img + (size_t)j * e;
    const float cx = (sigmoid(p[0]) + geom[j]) * geom[2 * n + j];
    const float cy = (sigmoid(p[1]) + geom[n + j]) * geom[3 * n + j];
    const float bw = expf(p[2]) * geom[4 * n + j];
    const float bh = expf(p[3]) * geom[5 * n + j];
    const float oy = (cy - off_y) * sy;
    const float ox = (cx - off_x) * sx;
    const float oh = bh * sy;
    const float ow = bw * sx;
    s_y0[j] = (oy - oh * 0.5f) * ih;
    s_x0[j] = (ox - ow * 0.5f) * iw;
    s_y1[j] = (oy + oh * 0.5f) * ih;
    s_x1[j] = (ox + ow * 0.5f) * iw;
    const float conf = sigmoid(p[4]);
    float s;
    if (class_softmax) {
      // softmax over the real classes, summed in class order
      float mx = p[5];
      for (int k = 1; k < classes; ++k) mx = nan_max(mx, p[5 + k]);
      float sum = expf(p[5] - mx);
      for (int k = 1; k < classes; ++k) sum = sum + expf(p[5 + k] - mx);
      s = expf(p[5 + c] - mx) / sum * conf;
    } else {
      s = sigmoid(p[5 + c]) * conf;
    }
    s_score[j] = s;
    if (better(s, j, best_v, best_i)) { best_v = s; best_i = j; }
  }
  block_argmax(best_v, best_i, red_v, red_i);

  float* os = out_scores + ((size_t)b * classes + c) * max_out;
  float* ob = out_boxes + ((size_t)b * classes + c) * max_out * 4;
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

}  // namespace

extern "C" {

// Shared memory one block needs for n candidates.
size_t yolo_head_smem_bytes(int n) { return (size_t)5 * n * sizeof(float); }

// The most dynamic shared memory a block of the kernel may ask for on the
// current device: the opt-in limit less the kernel's static shared memory.
// Returns the cudaError_t of the queries.
int yolo_head_max_dynamic_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, yolo_head_kernel);
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)attr.sharedSizeBytes;
  return 0;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
int yolo_head_decode_nms(const float* preds, const float* geom,
                         const float* lbox, float* out_scores,
                         float* out_boxes, int batch, int n, int classes,
                         int max_out, float iou_thresh, float score_thresh,
                         int class_softmax, void* stream) {
  const size_t smem = yolo_head_smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        yolo_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(classes, batch);
  yolo_head_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      preds, geom, lbox, out_scores, out_boxes, n, classes, max_out,
      iou_thresh, score_thresh, class_softmax);
  return (int)cudaGetLastError();
}

const char* yolo_head_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
