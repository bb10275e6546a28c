// Fused YOLO head for Hopper (sm_90a): decode + letterbox inverse + per-class
// greedy NMS, one thread block per (class, image) row.  The selection loop
// is the shared one of greedy_select.cuh.
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

#include "greedy_select.cuh"
#include "smem.cuh"

namespace {

using greedy::better;
using greedy::block_argmax;
using greedy::kThreads;
using greedy::kWarps;
using greedy::nan_max;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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
  greedy::select_row(s_score, s_y0, s_x0, s_y1, s_x1, n, max_out, iou_thresh,
                     score_thresh, best_v, best_i, red_v, red_i, os, ob);
}

}  // namespace

extern "C" {

// Shared memory one block needs for n candidates.
size_t yolo_head_smem_bytes(int n) { return (size_t)5 * n * sizeof(float); }

// The most dynamic shared memory a block of the kernel may ask for on the
// current device.  Returns the cudaError_t of the queries.
int yolo_head_max_dynamic_smem(int* bytes) {
  return max_dynamic_smem(yolo_head_kernel, bytes);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
int yolo_head_decode_nms(const float* preds, const float* geom,
                         const float* lbox, float* out_scores,
                         float* out_boxes, int batch, int n, int classes,
                         int max_out, float iou_thresh, float score_thresh,
                         int class_softmax, void* stream) {
  // the default limit (48 KB) counts static and dynamic shared memory
  // together, so opt in to the dynamic size on every launch
  const size_t smem = yolo_head_smem_bytes(n);
  const cudaError_t err = cudaFuncSetAttribute(
      yolo_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
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
